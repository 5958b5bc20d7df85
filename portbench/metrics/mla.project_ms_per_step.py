"""mla.project_ms_per_step (ms): device time per step under the port's
range ``mla.project`` (mla.mla: the q, kv_a and kv_b projections with
their weights' casts, the latent's RMSNorm, the rotation of the roped
dims, the assembly of q and k) and under the backward nodes linked to it
(portbench/named_ranges.py). None where the trace holds no such range."""

from portbench import named_ranges


def read(run):
    return named_ranges.range_ms_per_step(run, "mla.project")
