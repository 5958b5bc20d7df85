"""drmc CLI: ``python -m tpu_dra_torch.analysis.drmc``.

Default run: explore every gate interleaving scenario under the given
budget AND enumerate 100% of every crash scenario's crash points. Exits
non-zero on the first invariant violation, printing the violating
schedule trace (replay with ``--replay-trace``) or crash point.

The gate also self-enforces the exploration floor: with ``--min-
schedules N``, finishing under budget with fewer than N distinct
interleavings fails — a silently shrunken scenario must not turn the
gate green by exploring nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_dra_torch.analysis.drmc import crash as crash_mod
from tpu_dra_torch.analysis.drmc import explore as explore_mod
from tpu_dra_torch.analysis.drmc.scenarios import (
    CRASH_SCENARIOS, GATE_SCENARIOS, INTERLEAVING_SCENARIOS,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dra_torch.analysis.drmc",
        description="deterministic interleaving + crash-point model "
                    "checker (SURVEY §13)")
    ap.add_argument("--scenario", action="append", default=[],
                    help="scenario name, interleaving or crash "
                         "(repeatable; default: "
                         f"{', '.join(GATE_SCENARIOS)} + every crash "
                         "scenario)")
    ap.add_argument("--budget", type=int, default=150,
                    help="max schedules per interleaving scenario")
    ap.add_argument("--max-steps", type=int, default=5000)
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="wall-clock seconds per scenario")
    ap.add_argument("--min-schedules", type=int, default=0,
                    help="fail if TOTAL distinct interleavings explored "
                         "is below this floor")
    ap.add_argument("--min-crash-points", type=int, default=1,
                    help="fail if any crash scenario enumerates fewer "
                         "points — 0/0 coverage is vacuous, not green "
                         "(catches a durability refactor that stops "
                         "routing writes through the vfs seam)")
    ap.add_argument("--skip-crash", action="store_true",
                    help="interleaving engines only")
    ap.add_argument("--skip-explore", action="store_true",
                    help="crash engine only")
    ap.add_argument("--replay-trace", default="",
                    help="JSON list of task ids: replay this schedule on "
                         "the (single) --scenario instead of exploring")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    # Resolve names up front: a typo (or a crash-scenario name fed to
    # the explorer) must be a clean usage error, not a KeyError dump.
    if args.scenario:
        unknown = [n for n in args.scenario
                   if n not in INTERLEAVING_SCENARIOS
                   and n not in CRASH_SCENARIOS]
        if unknown:
            print(f"unknown scenario(s): {', '.join(unknown)} — "
                  "interleaving: "
                  f"{', '.join(sorted(INTERLEAVING_SCENARIOS))}; crash: "
                  f"{', '.join(sorted(CRASH_SCENARIOS))}", file=sys.stderr)
            return 2
        names = [n for n in args.scenario if n in INTERLEAVING_SCENARIOS]
        crash_names = [n for n in args.scenario if n in CRASH_SCENARIOS]
    else:
        names = list(GATE_SCENARIOS)
        crash_names = sorted(CRASH_SCENARIOS)
    summary = {"explore": [], "crash": [], "violations": []}

    if args.replay_trace:
        if len(names) != 1:
            print("--replay-trace needs exactly one interleaving "
                  "--scenario", file=sys.stderr)
            return 2
        scenario = INTERLEAVING_SCENARIOS[names[0]]()
        outcome = explore_mod.replay(scenario,
                                     json.loads(args.replay_trace),
                                     max_steps=args.max_steps)
        print(json.dumps({"trace": outcome.trace, "ops": outcome.ops,
                          "violations": outcome.violations}, indent=2))
        return 1 if outcome.violations else 0

    if not args.skip_explore:
        for name in names:
            scenario = INTERLEAVING_SCENARIOS[name]()
            report = explore_mod.explore(
                scenario, budget=args.budget, max_steps=args.max_steps,
                deadline_s=args.deadline)
            summary["explore"].append(report.to_dict())
            if report.violation is not None:
                summary["violations"].append(
                    f"[{name}] invariant violation — replay with: "
                    "python -m tpu_dra_torch.analysis.drmc --scenario "
                    f"{name} --replay-trace "
                    f"'{json.dumps(report.violation.trace)}'")
                summary["violations"].extend(
                    f"[{name}] {v}" for v in report.violation.violations)

    if not args.skip_crash:
        for name in crash_names:
            report = crash_mod.enumerate_crashes(CRASH_SCENARIOS[name]())
            summary["crash"].append(report.to_dict())
            summary["violations"].extend(
                f"[{name}] {v}" for v in report.violations)
            if report.points_run != report.points_enumerated:
                summary["violations"].append(
                    f"[{name}] crash coverage "
                    f"{report.points_run}/{report.points_enumerated} "
                    "— 100% required")
            if report.points_enumerated < args.min_crash_points:
                summary["violations"].append(
                    f"[{name}] only {report.points_enumerated} crash "
                    f"points enumerated (< floor {args.min_crash_points})"
                    " — did the durability layer stop going through "
                    "infra/vfs.py?")

    total_distinct = sum(e["distinct"] for e in summary["explore"])
    summary["distinct_total"] = total_distinct
    if (not args.skip_explore and args.min_schedules
            and total_distinct < args.min_schedules):
        summary["violations"].append(
            f"explored only {total_distinct} distinct interleavings "
            f"(< floor {args.min_schedules})")

    if args.as_json:
        print(json.dumps(summary, indent=2))
    else:
        for e in summary["explore"]:
            print(f"explore {e['scenario']}: {e['schedules']} schedules, "
                  f"{e['distinct']} distinct, "
                  f"frontier_exhausted={e['frontier_exhausted']}, "
                  f"{e['elapsed_s']}s")
        for c in summary["crash"]:
            print(f"crash {c['scenario']}: "
                  f"{c['points_run']}/{c['points_enumerated']} points "
                  f"({len(c['ops'])} durable ops)")
        for v in summary["violations"]:
            print(f"VIOLATION: {v}")
    return 1 if summary["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
