"""model.gemm_ms_per_step (ms): device time per step of cuBLAS's GEMMs
(frozen.category "matmul (cuBLAS)"), forward, backward and any in the
optimizer. None where the trace holds no GEMM."""

from portbench import frozen


def read(run):
    return run.category_ms_per_step(frozen.GEMM)
