"""moe.expert_fill (%): 100 x the port's counter ``moe.kept`` (tokens kept
within an expert's capacity) over ``moe.slots`` (E x C), summed over
every route_top1 call of the traced steps (portbench/ranges.py): the
share of the rows of the dispatch, expert and combine GEMMs that carry a
token. None where the port counted no slots."""

from portbench import ranges


def read(run):
    counts = ranges.counters(run)
    slots = counts.get("moe.slots")
    if not slots:
        return None
    return 100.0 * counts.get("moe.kept", 0.0) / slots
