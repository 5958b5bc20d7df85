"""The comparison that decides ``correct`` for a training cell.

Both sides give, for the same weights and the same first batches:
each step's loss, the per-leaf norm of the first gradient as the
optimizer got it (worked out from the state after step 1: (p0 - p1) /
lr), and the per-leaf norm of the change after the first steps (p3 -
p0). The numbers, each with its limit in limits/<cell>.json (every cell
compares all five; limits that leave one out fail the run):

- ``loss_gap``: the largest |loss - ref| / |ref| over the steps;
- ``grad1_gap``: over leaves, the largest gap between the two gradient
  norms, |g - g_ref|, over the larger of the reference's norm of that
  leaf and of the median leaf (some leaves' gradients are all but zero);
- ``change_gap``: the same of the change norms, over leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf with a gradient nought to rounding moves by rounding alone);
- ``grad1_median_gap``, ``change_median_gap``: the median over leaves of
  the same per-leaf gaps: a fault that spreads thin over every leaf
  moves them where the worst leaf's rounding hides it.

Norm gaps, not norms of differences: the reference's draws and the
program's agree only as far as their precisions do, and a gap of norms
is what a step gone wrong (no update, half the batch) moves.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Sequence

NUMBERS = ("loss_gap", "grad1_gap", "change_gap", "grad1_median_gap",
           "change_median_gap")
REQUIRED = NUMBERS
SETTLED = 1e-3


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool]) -> List[float]:
    median = statistics.median(r for r, k in zip(ref, keep) if k)
    return [abs(p - r) / max(r, median)
            for p, r, k in zip(prog, ref, keep) if k]


def numbers(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Every number of the program's readings against the reference's."""
    median_g = statistics.median(ref["grad1"])
    moving = [g >= SETTLED * median_g for g in ref["grad1"]]
    grad1 = _leaf_gaps(prog["grad1"], ref["grad1"], [True] * len(moving))
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["losses"], ref["losses"])),
        "grad1_gap": max(grad1),
        "change_gap": max(change),
        "grad1_median_gap": statistics.median(grad1),
        "change_median_gap": statistics.median(change),
    }


def judge(nums: Dict[str, float], limits: Dict[str, Any]) -> tuple:
    """(correct, [(name, value, limit)]) over NUMBERS: every one at or
    under its limit; a missing or non-finite number fails, and so do
    limits that leave a number out (its row reads limit None)."""
    rows: List[tuple] = []
    ok = True
    for name in REQUIRED:
        value = nums.get(name, float("nan"))
        limit = limits.get("limits", {}).get(name)
        rows.append((name, value, limit))
        if limit is None or not value <= limit:
            ok = False
    return ok, rows


def leaf_report(prog: Dict[str, Any], ref: Dict[str, Any], names: Sequence[str],
                top: int = 4) -> Dict[str, Any]:
    """Diagnostics of a comparison (calibration only): the leaves with the
    largest gaps of each kind and the leaf at their median, as (gap, leaf,
    program's norm, reference's norm)."""
    out: Dict[str, Any] = {}
    for key in ("grad1", "change"):
        median = statistics.median(ref[key])
        gaps = sorted(((abs(p - r) / max(r, median), n, p, r)
                       for p, r, n in zip(prog[key], ref[key], names)),
                      reverse=True)
        out[f"{key}_worst"] = gaps[:top]
        out[f"{key}_median_leaf"] = gaps[len(gaps) // 2]
    return out
