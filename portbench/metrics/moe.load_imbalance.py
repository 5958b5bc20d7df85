"""moe.load_imbalance: the held experts' load spread, summed over every
route_topk call of the traced steps: sum of ``moe.load_max`` (the
largest held expert's pairs) over sum of ``moe.assigned`` (the held
pairs) / E_held, the experts held a call (``moe.held`` over the calls,
one step's tokens of ``moe.routed`` each). 1 is an even load; the
grouped GEMMs' longest group is this much above the mean. None where the
port counted no held pair or no held expert."""

from portbench import ranges


def read(run):
    counts = ranges.counters(run)
    if not counts.get("moe.assigned") or not counts.get("moe.held"):
        return None
    calls = counts["moe.routed"] / run.tokens_per_step
    held = counts["moe.held"] / calls
    return counts["moe.load_max"] / (counts["moe.assigned"] / held)
