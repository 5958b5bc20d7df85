"""dralint CLI: ``python -m tpu_dra_torch.analysis [paths...]``.

Lints the port's own tree (``tpu_dra_torch/``, ``tests/test_torch_*.py``
and ``chip_smoke.py``) against the port's registries under
``tpu_dra_torch/infra``. Exit status 0 = zero unsuppressed findings;
1 = findings. ``--sites-report`` prints the fault-site coverage table
(guard + arm locations per registered site); ``--locks-report`` the
draracer guarded-by table (one row per class attribute the R10
inference considered); ``--check-witness FILE`` additionally asserts a
runtime-exported lock-order edge set (infra.lockwitness.export_edges)
is a subset of the static graph; ``--require-justified`` fails when
any suppression comment lacks a justification string.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tpu_dra_torch.analysis import core, flowanalysis, raceanalysis, rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dra_torch.analysis",
        description="dralint: project-invariant static analyzer")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: tpu_dra_torch, "
                         "tests/test_torch_*.py and chip_smoke.py under "
                         "--root)")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: discovered from paths/cwd)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the per-file result "
                         "cache (.dralint-cache.json)")
    ap.add_argument("--jobs", default="1",
                    help="scan-phase worker processes: an int, or "
                         "'auto' for min(8, cpu count) (cold "
                         "whole-tree runs; warm runs are cache-bound "
                         "and stay serial)")
    ap.add_argument("--rule-table", action="store_true",
                    help="print the per-rule findings/suppressions/"
                         "timing table after the run")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument("--sites-report", action="store_true",
                    help="also print the fault-site coverage table "
                         "(guard + arm locations per registered site), "
                         "from the same scan")
    ap.add_argument("--locks-report", action="store_true",
                    help="also print the draracer guarded-by table "
                         "(per class attribute: inferred/annotated "
                         "guard + guarded/unguarded access counts)")
    ap.add_argument("--check-witness", metavar="FILE", default=None,
                    help="assert the runtime lock-order edge set "
                         "exported to FILE is a subset of the static "
                         "lock-order graph (observed ⊆ static); an "
                         "unexplained runtime edge exits 1")
    ap.add_argument("--check-view-shadow", metavar="FILE", default=None,
                    help="assert every runtime view-shadow drift "
                         "exported to FILE (k8s.informer.viewshadow) "
                         "maps to a statically R13-implicated view "
                         "seed (observed ⊆ static); an unexplained "
                         "drift exits 1")
    ap.add_argument("--require-justified", action="store_true",
                    help="fail when any suppressed finding's ignore "
                         "comment carries no justification string")
    args = ap.parse_args(argv)

    root = args.root or core.find_root(
        Path(args.paths[0]) if args.paths else Path.cwd())
    if args.paths:
        paths = [Path(p) for p in args.paths]
        missing = [p for p in paths if not p.exists()]
        if missing:
            # A typo'd path silently linting nothing would turn the
            # hard gate green for the wrong reason: fail loudly.
            print("dralint: no such path(s): "
                  + ", ".join(str(p) for p in missing), file=sys.stderr)
            return 2
    else:
        paths = core.default_paths(root)

    rule_ids = ({r.strip() for r in args.rules.split(",") if r.strip()}
                or None)
    if rule_ids is not None:
        if args.sites_report:
            rule_ids.add("R4")  # the table is R4's collection
        if args.locks_report or args.check_witness:
            rule_ids.add("R9")  # draracer's collection (R9-R11)
        if args.check_view_shadow:
            rule_ids.add("R13")  # drflow's collection (R13-R15)
    active = core.all_rules()
    report = core.run(paths, root=root, rules=active, rule_ids=rule_ids,
                      use_cache=not args.no_cache, jobs=args.jobs)
    print(core.render(report, as_json=args.as_json,
                      show_suppressed=args.show_suppressed))
    # Under --json, stdout is the machine-readable document — the
    # report tables and gate diagnostics go to stderr instead.
    out = sys.stderr if args.as_json else sys.stdout
    status = 0 if report.ok else 1
    if args.sites_report:
        # Reuses the lint pass's R4 collection and parsed registries —
        # one tree scan, one registry parse total.
        r4 = next(r for r in active
                  if isinstance(r, rules.FaultSiteRegistry))
        ctx = report.ctx
        print(f"{'site':34} {'guards':>7} {'arms':>5}", file=out)
        for site, guards, arms in rules.site_coverage(r4, ctx):
            print(f"{site:34} {len(guards):7d} {len(arms):5d}", file=out)
            for loc in guards:
                print(f"    guard {loc}", file=out)
            for loc in arms:
                print(f"    arm   {loc}", file=out)
    race = next(r for r in active
                if isinstance(r, raceanalysis.RaceAnalysis))
    if args.locks_report:
        # Same pattern: the lint pass's R10 inference, re-rendered.
        rows = raceanalysis.locks_report(race)
        print(f"{'class.attr':58} {'guard':16} {'how':>10} "
              f"{'grd':>4} {'ungrd':>5}", file=out)
        for row in rows:
            name = f"{row['class']}.{row['attr']}"
            print(f"{name:58} {str(row['guard']):16} {row['how']:>10} "
                  f"{row['guarded']:4d} {row['unguarded']:5d}", file=out)
    if args.rule_table:
        # One row per rule id: findings and
        # suppressions from the report's per-rule counts, wall-clock
        # from the runner's per-rule-class timers (a combined rule
        # bills its whole pass to its primary id; parallel scans bill
        # the pool under <scan-pool>).
        doc = report.to_dict()
        by_f = doc["findings_by_rule"]
        by_s = doc["suppressed_by_rule"]
        rows = set(by_f) | set(by_s) | set(report.timings)
        print(f"{'rule':12} {'findings':>8} {'suppressed':>10} "
              f"{'seconds':>8}", file=out)
        for rid in sorted(rows, key=lambda r: (r.startswith("<"),
                                               len(r), r)):
            t = report.timings.get(rid)
            secs = f"{t:8.3f}" if t is not None else f"{'-':>8}"
            print(f"{rid:12} {by_f.get(rid, 0):8d} "
                  f"{by_s.get(rid, 0):10d} {secs}", file=out)
    if args.check_view_shadow:
        from tpu_dra_torch.k8s import informer as informer_mod
        flow = next(r for r in active
                    if isinstance(r, flowanalysis.FlowAnalysis))
        try:
            drifts = informer_mod.load_drifts(args.check_view_shadow)
        except (OSError, ValueError) as exc:
            # Same contract as --check-witness: a missing export must
            # not turn the gate green.
            print(f"dralint: cannot read view-shadow export "
                  f"{args.check_view_shadow}: {exc}", file=sys.stderr)
            return 2
        problems = flowanalysis.check_view_shadow(flow, drifts)
        for p in problems:
            print(f"viewshadow: {p}", file=out)
        print(f"viewshadow: {len(drifts)} observed drift(s), "
              f"{len(flow.view_sites_recognized)} recognized view "
              f"site(s), {len(problems)} unexplained", file=out)
        if problems:
            status = max(status, 1)
    if args.check_witness:
        from tpu_dra_torch.infra import lockwitness
        try:
            observed = lockwitness.load_edges(args.check_witness)
        except (OSError, ValueError) as exc:
            # A missing/garbled export turning the gate green would be
            # the exact silent under-approximation the gate exists to
            # catch: fail loudly instead.
            print(f"dralint: cannot read witness export "
                  f"{args.check_witness}: {exc}", file=sys.stderr)
            return 2
        problems = raceanalysis.check_witness(race, observed)
        for p in problems:
            print(f"witness: {p}", file=out)
        print(f"witness: {len(observed)} observed edge(s), "
              f"{len(race.static_edges)} static, "
              f"{len(problems)} unexplained", file=out)
        if problems:
            status = max(status, 1)
    if args.require_justified and report.unjustified:
        for f in report.unjustified:
            print(f"{f.format()} (suppressed WITHOUT justification — "
                  "add a reason string to the ignore comment)", file=out)
        status = max(status, 1)
    return status


if __name__ == "__main__":
    sys.exit(main())
