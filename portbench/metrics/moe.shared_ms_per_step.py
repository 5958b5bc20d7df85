"""moe.shared_ms_per_step (ms): device time per step under the port's
range ``moe.shared`` (moe.topk_ffn: the shared expert's SwiGLU over every
token, with its weights' casts) and under the backward nodes linked to it
(portbench/named_ranges.py). None where the trace holds no such range."""

from portbench import named_ranges


def read(run):
    return named_ranges.range_ms_per_step(run, "moe.shared")
