"""``python -m tpu_dra_torch.race [N]``: the race tier's five steps in
order (see the package docstring), N runs of the threaded suites
(default 3). Each step prints one verdict line; the first failing step
stops the run, is named, and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_dra_torch.race import runner as race


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_dra_torch.race",
                                 description="the port's race tier")
    ap.add_argument("iterations", nargs="?", type=int, default=3,
                    help="runs of the threaded suites (default 3)")
    args = ap.parse_args(argv)
    race.OUT_DIR.mkdir(parents=True, exist_ok=True)
    for path in (race.EDGES, race.DRIFTS):
        path.unlink(missing_ok=True)
    steps = [
        ("lint", race.step_lint),
        ("drmc", race.step_drmc),
        ("tsan", race.step_tsan),
        ("suites", lambda: race.step_suites(iterations=args.iterations)),
        ("check", race.step_check),
    ]
    for name, step in steps:
        print(f">> {name}", flush=True)
        res = step()
        if not res["ok"]:
            print(json.dumps(res, indent=1, default=str), file=sys.stderr)
            print(f"race: step {name} FAILED", flush=True)
            return 1
        shown = {k: v for k, v in res.items()
                 if k not in ("ok", "reports", "tail")}
        print(f"race: {name} ok {json.dumps(shown, default=str)}",
              flush=True)
    print("race: tier green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
