"""moe.dispatch_ms_per_step (ms): device time per step under the port's
ranges ``moe.dispatch`` and ``moe.combine`` (moe._experts: the dense
[B,S,E,C] one-hot einsums into and out of the expert buffers, with their
operands' casts) and under the backward nodes linked to them
(portbench/ranges.py). None where the trace holds neither range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "moe.dispatch", "moe.combine")
