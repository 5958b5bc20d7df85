"""CPU tests of the benchmark (and one for the card, marked ``card``)."""
