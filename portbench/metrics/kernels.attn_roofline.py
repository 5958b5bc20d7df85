"""kernels.attn_roofline (%): the least time the attention work of a step
could take on the card, over the device time of the kernels that carry
it. The work is counted per attention call from its shape (frozen.bounds,
forward and backward, bf16), whatever kernels run it; the time is the
attention category's (frozen.category). None off a known card or where
the trace holds no attention kernel."""

from portbench import frozen


def read(run):
    ms = run.category_ms_per_step(frozen.ATTENTION)
    if ms is None or run.peaks is None:
        return None
    bound_ms = 0.0
    for b, s, h, d in run.attention_calls:
        work = frozen.bounds(b, s, h, d, run.peaks["bf16_flops"],
                             run.peaks["hbm_bytes"], elem=2)
        bound_ms += work["flash_fwd"]["bound_ms"] + work["flash_bwd"]["bound_ms"]
    return 100.0 * bound_ms / ms
