"""kernels.attn_ms_per_step (ms): device time per step of the port's
attention kernels (frozen.category "flash attention (port kernels)":
kernel names holding "flash_"). None where the trace holds none."""

from portbench import frozen


def read(run):
    return run.category_ms_per_step(frozen.ATTENTION)
