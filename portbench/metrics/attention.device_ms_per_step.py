"""attention.device_ms_per_step (ms): device time per step of everything
launched under the port's ranges ``attention.fwd`` (flashattention.attend:
rope tables, input copies, the forward kernel) and ``attention.bwd``
(_FlashAttention.backward: the dout cast, the delta pass, dQ's zero fill,
the fused backward), by the rule of portbench/ranges.py. None where the
trace holds neither range."""

from portbench import ranges


def read(run):
    return ranges.range_ms_per_step(run, "attention.fwd", "attention.bwd")
