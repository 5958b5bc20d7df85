"""The benchmark of the PyTorch/CUDA port (``tpu_dra_torch``) on one H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench --workload flagship.s1k_uniform --seed 123 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes (``family`` names the
  program builder ``models/<family>.py`` and the plain reference
  ``reference/<family>.py``);
- ``traffic/<traffic>.json``: the parameters the general generator
  (``traffic.py``) reads; ``driver`` names ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from.

``calibrate.py`` reads those numbers for the program, the control and the
planted faults, the readings the limits are set from. Nothing here
imports ``jax``, ``jaxlib``, ``flax`` or the JAX package ``tpu_dra``;
``reference/`` imports nothing of ``tpu_dra_torch`` either.
"""
