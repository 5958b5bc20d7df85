"""``python -m tpu_dra_torch.e2e [SUITE ...] [--fast] [--card-node]
[--keep-going]`` (counterpart of hack/e2e.sh: cluster up, the suites,
cluster down).

Starts the e2e cluster (tpu_dra_torch.e2e.cluster), then runs each suite
in turn after the cleanup of every namespace the suites made
(tests/e2e/run.sh), printing one JSON line per suite: {"suite", "ok",
"seconds", ...what the suite measured, or "error"}. Stops at the first
failure unless --keep-going. Exits 1 if any suite failed. --fast is
run.sh's fast-feedback subset (basics, admission, gpu_claims).
--card-node makes n0 this host, its plugins on NVML, and the training
pod of gpu_claims the flagship step on the card; without it every node
is simulated and the training pod runs a small model on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import sys
import time
import traceback
from typing import Dict, List, Optional

SUITES = ("basics", "admission", "gpu_claims", "stress", "multiprocess",
          "health", "debug", "cd_lifecycle", "cd_failover", "updowngrade")
FAST = ("basics", "admission", "gpu_claims")

def run_suite(e2e, name: str) -> Dict:
    """Cleanup, then the suite; its JSON record."""
    t0 = time.monotonic()
    rec: Dict = {"suite": name}
    logging.getLogger("tpu_dra_torch.e2e").info("suite %s", name)
    try:
        e2e.cleanup()
        mod = importlib.import_module(f"tpu_dra_torch.e2e.suite_{name}")
        rec.update(mod.run(e2e) or {})
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 # drflow: swallow-ok[a failed suite is recorded in its line, and the run's exit code]
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
    rec["seconds"] = time.monotonic() - t0
    return rec


def run(suites: List[str], *, card_node: bool = False,
        keep_going: bool = False, out=None) -> List[Dict]:
    """Bring the cluster up, run `suites`, bring it down; every suite's
    record, each also printed to `out` as one JSON line."""
    from tpu_dra_torch.e2e.cluster import E2ECluster
    from tpu_dra_torch.e2e.helpers import E2E

    out = out or sys.stdout
    up = E2ECluster(card_node=card_node)
    records: List[Dict] = []
    try:
        t0 = time.monotonic()
        up.start()
        e2e = E2E(up)
        print(json.dumps({"suite": "up", "ok": True,
                          "seconds": time.monotonic() - t0}),
              file=out, flush=True)
        for name in suites:
            rec = run_suite(e2e, name)
            records.append(rec)
            print(json.dumps(rec), file=out, flush=True)
            if not rec["ok"] and not keep_going:
                break
        e2e.cleanup()
    finally:
        up.stop()
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_dra_torch.e2e")
    ap.add_argument("suites", nargs="*", metavar="SUITE",
                    help=f"suites to run, of {', '.join(SUITES)} "
                         "(default: all, in that order)")
    ap.add_argument("--fast", action="store_true",
                    help=f"the fast-feedback subset: {', '.join(FAST)}")
    ap.add_argument("--card-node", action="store_true",
                    help="n0 is this host, its GPUs read by NVML")
    ap.add_argument("--keep-going", action="store_true",
                    help="run every suite even after one failed")
    args = ap.parse_args(argv)
    # Progress (each wait and how long it took, the cluster's own
    # events) goes to stderr; the suites' lines to stdout.
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    suites = args.suites or list(FAST if args.fast else SUITES)
    unknown = [s for s in suites if s not in SUITES]
    if unknown:
        ap.error(f"unknown suites {unknown} (known: {', '.join(SUITES)})")
    records = run(suites, card_node=args.card_node,
                  keep_going=args.keep_going)
    ok = len(records) == len(suites) and all(r["ok"] for r in records)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
