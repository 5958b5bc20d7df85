"""attention.window_ms_per_step (ms): device time per step under the
port's range ``attention.window`` (mimo_model.hybrid_attention: a window
layer's attend call, the forward kernel with the band, and the sink
rescale) and under the backward nodes linked to it, the fused backward
included (portbench/window_ranges.py). None where the trace holds no
such range."""

from portbench import window_ranges


def read(run):
    program = window_ranges.of(run)
    if program is None:
        return None
    return program.range_ms_per_step(window_ranges.WINDOW)
