"""moe.route_ms_per_step (ms): device time per step under the port's
range ``moe.route`` (moe.route_top1: router matmul, softmax, argmax,
one-hot, cumsum, keep mask, the [B,S,E,C] dispatch and combine masks,
aux) and under the backward nodes linked to it (portbench/ranges.py).
None where the trace holds no such range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "moe.route")
