"""drmc interleaving explorer: DPOR-lite DFS over controlled schedules.

One *scenario* (see scenarios.py) is run many times under the
controlled scheduler: the first run takes the default schedule
(lowest-tid-first), and every choice point where another enabled task's
pending operation CONFLICTS with the chosen one — same lock class,
same queue key, same condition (the reduction rule) —
becomes a backtrack point. The explorer re-runs the scenario with that
prefix redirected, depth-first, until the frontier is exhausted or the
budget (schedules / wall clock) runs out. Choice points whose enabled
ops are pairwise independent are never branched: reordering them
cannot change any observable state, which is what makes exhaustive
exploration of small scheduler+prepare scenarios affordable in CI.

Every terminal state runs the scenario's invariant checks plus the
lock-order witness's cycle/outlier check for the run's window; the
first violating schedule is returned with its full decision trace,
which ``replay()`` (and ``python -m tpu_dra_torch.analysis.drmc --replay``)
re-executes deterministically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from tpu_dra_torch.infra import lockwitness
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DRMC_CRASHPOINTS, DRMC_SCHEDULES
from tpu_dra_torch.analysis.drmc.sched import CooperativeScheduler, RunResult


@dataclass
class ScheduleOutcome:
    trace: List[int]
    ops: List[str]
    violations: List[str]


@dataclass
class ExploreReport:
    scenario: str
    schedules: int = 0              # runs performed
    distinct: int = 0               # distinct complete traces observed
    frontier_exhausted: bool = False
    violation: Optional[ScheduleOutcome] = None
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.violation is None

    def to_dict(self) -> Dict:
        out = {"scenario": self.scenario, "schedules": self.schedules,
               "distinct": self.distinct,
               "frontier_exhausted": self.frontier_exhausted,
               "elapsed_s": round(self.elapsed_s, 3)}
        if self.violation is not None:
            out["violation"] = {"trace": self.violation.trace,
                                "ops": self.violation.ops,
                                "violations": self.violation.violations}
        return out


def run_schedule(scenario, schedule: Optional[List[int]] = None,
                 max_steps: int = 5000) -> Tuple[RunResult, List[str]]:
    """One controlled run of `scenario` under `schedule` (replayed as a
    prefix; default policy beyond it). Returns the scheduler's RunResult
    and the merged violation list (scheduler + scenario invariants +
    lock-order witness for this run's window)."""
    # Witness install BEFORE the scenario builds its stack: every lock
    # the stack creates must be both modeled (yield points) and order-
    # checked. reset=False — under a session-level install the graph
    # belongs to everyone; the snapshot window scopes our assertion.
    lockwitness.install(reset=False)
    snap = lockwitness.WITNESS.snapshot()
    sched = CooperativeScheduler(schedule=schedule, max_steps=max_steps)
    ctx = None
    try:
        ctx = scenario.build(sched)
        result = sched.run()
        violations = list(result.violations)
        if not violations:
            violations.extend(scenario.check(ctx))
        violations.extend(lockwitness.WITNESS.violations_since(snap))
        return result, violations
    finally:
        try:
            if ctx is not None:
                scenario.cleanup(ctx)
        finally:
            FAULTS.reset()
            lockwitness.uninstall()


def explore(scenario, budget: int = 200, max_steps: int = 5000,
            deadline_s: float = 120.0,
            stop_on_violation: bool = True) -> ExploreReport:
    """Systematically explore `scenario`'s interleavings (module doc)."""
    t0 = time.monotonic()
    report = ExploreReport(scenario=scenario.name)
    frontier: List[List[int]] = [[]]
    tried: Set[Tuple[int, ...]] = set()
    seen_traces: Set[Tuple[int, ...]] = set()
    while frontier:
        if report.schedules >= budget:
            break
        if time.monotonic() - t0 > deadline_s:
            break
        prefix = frontier.pop()       # DFS: deepest backtrack first
        result, violations = run_schedule(scenario, prefix, max_steps)
        report.schedules += 1
        DRMC_SCHEDULES.inc(labels={"scenario": scenario.name})
        trace = tuple(result.trace)
        if trace not in seen_traces:
            seen_traces.add(trace)
            report.distinct += 1
        if violations:
            report.violation = ScheduleOutcome(
                trace=list(result.trace), ops=list(result.ops),
                violations=violations)
            if stop_on_violation:
                break
        for step, alts in result.branches:
            for alt in alts:
                cand = tuple(result.trace[:step]) + (alt,)
                if cand not in tried:
                    tried.add(cand)
                    frontier.append(list(cand))
    report.frontier_exhausted = not frontier
    report.elapsed_s = time.monotonic() - t0
    return report


def replay(scenario, trace: List[int],
           max_steps: int = 5000) -> ScheduleOutcome:
    """Re-execute a recorded schedule. The controlled scheduler errors
    on any divergence, so a clean replay is proof the trace drives the
    identical execution — the violation-reproduction seam."""
    result, violations = run_schedule(scenario, trace, max_steps)
    return ScheduleOutcome(trace=list(result.trace),
                           ops=list(result.ops), violations=violations)


def note_crash_points(n: int, scenario: str) -> None:
    """Metric seam for the crash engine (kept here so both exploration
    counters live in one module the catalog points at)."""
    if n:
        DRMC_CRASHPOINTS.inc(n, labels={"scenario": scenario})
