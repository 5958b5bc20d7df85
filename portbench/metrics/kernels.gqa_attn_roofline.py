"""kernels.gqa_attn_roofline (%): the least time the global layers'
grouped-query attention of a step could take on the card, over the
device time of the kernels that carry it. Each global call (W = 0 in the
family's attention_calls, (B, S, Hq, Hkv, Dqk, Dv, W)) is counted from
its shape (models/mimo_lm.py: hybrid_attention_bounds, causal pairs,
forward and fused backward, bf16, k and v at Hkv heads in the bytes);
the time is that of the kernels named "flash_" outside the range
``attention.window`` and its linked backward (portbench/
window_ranges.py). None off a known card, without global calls or a
window range to tell them apart by."""

from portbench import window_ranges
from portbench.models.mimo_lm import hybrid_attention_bounds


def read(run):
    calls = [c for c in run.attention_calls if len(c) == 7 and not c[-1]]
    times = window_ranges.attention_ms(run)
    if run.peaks is None or not calls or not times or not times[1]:
        return None
    bound_ms = 0.0
    for call in calls:
        work = hybrid_attention_bounds(*call, run.peaks["bf16_flops"],
                                       run.peaks["hbm_bytes"], elem=2)
        bound_ms += work["flash_fwd"]["bound_ms"] + work["flash_bwd"]["bound_ms"]
    return 100.0 * bound_ms / times[1]
