"""kernels.kda_roofline (%): the least time the KDA recurrence of a step
could take on the card, over the device time of the kernels that carry
it. Each KDA call ((B, S, H, dk, dv), the family's attention_calls(...)
.kda) is bound by the larger of its chunk-form FLOPs and its compulsory
bytes, forward and backward (models/kimi_lm.py: kda_bounds); the calls
are the ones the port counted, its counter ``attention.kda_tokens`` (B x
S a call) over the traced steps against the calls' tokens; the time is
that of the kernels whose names hold "kda_" (csrc/kda_chunk.cu). None
off a known card, without KDA calls, the counter or such kernels."""

from portbench import ranges
from portbench.models.kimi_lm import KDA_KERNEL, kda_bounds


def read(run):
    calls = getattr(run.attention_calls, "kda", None)
    tokens = ranges.counters(run).get("attention.kda_tokens")
    us = [end - start for start, end, name in run.kernels if KDA_KERNEL in name]
    if run.peaks is None or not calls or not tokens or not us:
        return None
    # The calls counted per step, as a share of the calls listed.
    share = tokens / run.steps / sum(c[0] * c[1] for c in calls)
    bound_ms = 0.0
    for call in calls:
        work = kda_bounds(*call, run.peaks["bf16_flops"],
                          run.peaks["hbm_bytes"])
        bound_ms += work["kda_fwd"]["bound_ms"] + work["kda_bwd"]["bound_ms"]
    return 100.0 * share * bound_ms / (sum(us) / run.steps / 1e3)
