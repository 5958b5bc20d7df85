"""kernels.mla_attn_roofline (%): the least time the latent attention of
a step could take on the card, over the device time of the kernels that
carry it. Each call's work is counted from its shape, (B, S, H, Dqk, Dv)
as the family's attention_calls gives it (models/dsv3_lm.py:
mla_attention_bounds, forward and fused backward, bf16, causal pairs);
the time is the attention category's (frozen.category: kernel names
holding "flash_"). None off a known card, where the trace holds no
attention kernel, or where a call's shape names no separate v head
dim."""

from portbench import frozen
from portbench.models.dsv3_lm import mla_attention_bounds


def read(run):
    ms = run.category_ms_per_step(frozen.ATTENTION)
    if ms is None or run.peaks is None:
        return None
    bound_ms = 0.0
    for call in run.attention_calls:
        if len(call) != 5:
            return None
        work = mla_attention_bounds(*call, run.peaks["bf16_flops"],
                                    run.peaks["hbm_bytes"], elem=2)
        bound_ms += work["flash_fwd"]["bound_ms"] + work["flash_bwd"]["bound_ms"]
    return 100.0 * bound_ms / ms
