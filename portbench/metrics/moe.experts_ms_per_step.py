"""moe.experts_ms_per_step (ms): device time per step under the port's
range ``moe.experts`` (moe._experts: up-projection, gelu, down-projection
with the weights' casts) and under the backward nodes linked to it
(portbench/ranges.py). None where the trace holds no such range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "moe.experts")
