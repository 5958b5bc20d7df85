"""kernels.swa_attn_roofline (%): the least time the sliding-window
attention of a step could take on the card, over the device time of the
kernels that carry it. Each window call (W > 0 in the family's
attention_calls, (B, S, Hq, Hkv, Dqk, Dv, W)) is bound by the larger of
the FLOPs of the pairs its band holds (the port's counter
``attention.window_pairs``, shared evenly among the traced window
calls) and its compulsory bytes (models/mimo_lm.py:
hybrid_attention_bounds, forward and fused backward, bf16); the time is
that of the kernels named "flash_" under the range ``attention.window``
and its linked backward (portbench/window_ranges.py). None off a known
card, without window calls, counters or a window range."""

from portbench import ranges, window_ranges
from portbench.models.mimo_lm import hybrid_attention_bounds


def read(run):
    calls = [c for c in run.attention_calls if len(c) == 7 and c[-1]]
    pairs = ranges.counters(run).get("attention.window_pairs")
    times = window_ranges.attention_ms(run)
    if run.peaks is None or not calls or not pairs or not times \
            or not times[0]:
        return None
    per_call = pairs / (run.steps * len(calls))
    bound_ms = 0.0
    for call in calls:
        work = hybrid_attention_bounds(*call, run.peaks["bf16_flops"],
                                       run.peaks["hbm_bytes"], elem=2,
                                       pairs=per_call)
        bound_ms += work["flash_fwd"]["bound_ms"] + work["flash_bwd"]["bound_ms"]
    return 100.0 * bound_ms / times[0]
