"""The program side of each model family: builds the port's train step on
the benchmark's weights, and counts its work."""
