"""attention.kda_ms_per_step (ms): device time per step under the port's
range ``attention.kda`` (kda.kda: a KDA layer's short convs, SiLU, L2
norms, decay and beta, the chunk kernels' forward and the gated RMSNorm)
and under the backward nodes linked to it, the chunk kernels' backward
included (portbench/kda_ranges.py). None where the trace holds no such
range."""

from portbench import kda_ranges


def read(run):
    program = kda_ranges.of(run)
    if program is None:
        return None
    return program.range_ms_per_step(kda_ranges.KDA)
