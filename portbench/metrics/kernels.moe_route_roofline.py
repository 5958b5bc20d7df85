"""kernels.moe_route_roofline (%): the least time the MoE layer's own CUDA
kernels of a step (csrc/moe_route.cu by name: the top-k route scan, the
row gathers, the k-way combine, the pair dot; models/dsv3_lm.py:
MOE_KERNELS) could take at 3.35 TB/s, over their device time. Their
compulsory bytes (models/dsv3_lm.py: moe_kernel_bytes) come from the
port's counters, summed over the traced steps' route_topk calls: the
tokens (moe.routed; one step's tokens a call), the pairs selected
(moe.selected) and held (moe.assigned), the tokens with a held pair
(moe.tokens_held) and the bytes of a row (moe.row_bytes). None off a known card, where the trace holds none of
the kernels or the port counted no held pair or no row."""

from portbench import ranges
from portbench.models.dsv3_lm import MOE_KERNELS, moe_kernel_bytes


def read(run):
    us = [end - start for start, end, name in run.kernels
          if any(k in name for k in MOE_KERNELS)]
    counts = ranges.counters(run)
    if not us or run.peaks is None or not counts.get("moe.assigned") \
            or "moe.tokens_held" not in counts \
            or not counts.get("moe.row_bytes"):
        return None
    calls = counts["moe.routed"] / run.tokens_per_step
    nbytes = calls * moe_kernel_bytes(
        run.tokens_per_step, counts["moe.selected"] / calls,
        counts["moe.assigned"] / calls, counts["moe.tokens_held"] / calls,
        counts["moe.row_bytes"] / calls)
    bound_us = nbytes / run.peaks["hbm_bytes"] * 1e6
    return 100.0 * bound_us / sum(us)
