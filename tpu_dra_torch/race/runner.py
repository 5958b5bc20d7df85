"""The race tier's steps, each a function that takes its files and sizes
as arguments and returns its record, ``ok`` its verdict (the tier is
described in the package docstring; ``python -m tpu_dra_torch.race``
runs them in order)."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from tpu_dra_torch.race import DRIFTS_ENV, EDGES_ENV, tsan_drive

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "race"
EDGES = OUT_DIR / "edges.json"
DRIFTS = OUT_DIR / "view-drifts.json"
# The counterparts of the reference's threaded suites (test_cd_integration,
# test_stress_failover, test_multiprocess_e2e).
SUITES = ("tests/test_torch_cd_integration.py",
          "tests/test_torch_leaderelect.py",
          "tests/test_torch_sharing.py")
DRMC_BUDGET = 600
# The witness's export file (the port's reads the reference's env name),
# and conftest's switch for the reference's session witness.
WITNESS_EXPORT_ENV = "TPU_DRA_LOCK_WITNESS_EXPORT"
REFERENCE_WITNESS_ENV = "TPU_DRA_LOCK_WITNESS"

_CHECK_LINES = {
    "witness": (re.compile(r"witness: (\d+) observed edge\(s\), (\d+) "
                           r"static, (\d+) unexplained"),
                ("observed", "static", "unexplained")),
    "viewshadow": (re.compile(r"viewshadow: (\d+) observed drift\(s\), "
                              r"(\d+) recognized view site\(s\), (\d+) "
                              r"unexplained"),
                   ("drifts", "recognized_sites", "unexplained")),
}


def _run(args: Sequence[str], env: Optional[Dict[str, str]] = None,
         timeout: float = 3600) -> tuple:
    """`python <args>` from the checkout's root, output captured; the
    completed process and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                          env=env or dict(os.environ), capture_output=True,
                          text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def _tail(proc, n: int = 1500) -> str:
    return (proc.stdout + proc.stderr)[-n:]


def check_counts(out: str, kind: str) -> Optional[Dict[str, int]]:
    """The counts of dralint's ``witness:`` or ``viewshadow:`` summary
    line in `out`, or None when it printed none."""
    pat, keys = _CHECK_LINES[kind]
    m = pat.search(out)
    return dict(zip(keys, map(int, m.groups()))) if m else None


def step_lint() -> Dict:
    proc, secs = _run(["-m", "tpu_dra_torch.analysis",
                       "--require-justified"], timeout=600)
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    return {"ok": proc.returncode == 0, "seconds": secs,
            "summary": last[0], "returncode": proc.returncode,
            **({} if proc.returncode == 0 else {"tail": _tail(proc)})}


def step_drmc(edges: Path = EDGES, budget: int = DRMC_BUDGET) -> Dict:
    proc, secs = _run(["-m", "tpu_dra_torch.analysis.drmc", "--budget",
                       str(budget), "--skip-crash", "--json"],
                      env={**os.environ, WITNESS_EXPORT_ENV: str(edges)})
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        doc = {}
    return {"ok": proc.returncode == 0 and bool(doc), "seconds": secs,
            "distinct": {e["scenario"]: e["distinct"]
                         for e in doc.get("explore", ())},
            "violations": doc.get("violations", [])[:5],
            "returncode": proc.returncode,
            **({} if proc.returncode == 0 else {"tail": _tail(proc)})}


def step_tsan(rounds: int = tsan_drive.ROUNDS,
              probes: int = tsan_drive.PROBES) -> Dict:
    return tsan_drive.drive(rounds=rounds, probes=probes)


def suite_env(edges: Path, drifts: Path) -> Dict[str, str]:
    """The environment of a witnessed suite run: the port's view shadow
    on, its exports named, and the reference's session witness off."""
    env = {**os.environ, "TPU_DRA_VIEW_SHADOW": "1",
           EDGES_ENV: str(edges), DRIFTS_ENV: str(drifts)}
    # conftest's switches: the reference's witness, and where it exports
    # the reference's view shadow.
    for name in (REFERENCE_WITNESS_ENV, "TPU_DRA_VIEW_SHADOW_EXPORT"):
        env.pop(name, None)
    return env


def step_suites(paths: Sequence[str] = SUITES, iterations: int = 3,
                edges: Path = EDGES, drifts: Path = DRIFTS) -> Dict:
    """`iterations` pytest runs over `paths` under the plugin; the
    verdict is every run's exit code 0 (3 is a cycle or a drift)."""
    runs: List[Dict] = []
    for _ in range(iterations):
        proc, secs = _run(["-m", "pytest", "-p", "tpu_dra_torch.race.plugin",
                           "-q", "-p", "no:cacheprovider", *paths],
                          env=suite_env(edges, drifts))
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        runs.append({"returncode": proc.returncode, "seconds": secs,
                     "summary": last[0],
                     **({} if proc.returncode == 0
                        else {"tail": _tail(proc, 3000)})})
    return {"ok": all(r["returncode"] == 0 for r in runs), "runs": runs,
            "seconds": sum(r["seconds"] for r in runs)}


def step_check(edges: Path = EDGES, drifts: Path = DRIFTS) -> Dict:
    """observed within static, over the merged exports: 0 unexplained
    edges (and at least one edge observed: an empty export means the
    witness saw nothing) and 0 unexplained drifts."""
    proc, secs = _run(["-m", "tpu_dra_torch.analysis", "--root", str(ROOT),
                       "--check-witness", str(edges),
                       "--check-view-shadow", str(drifts)], timeout=600)
    out = proc.stdout + proc.stderr
    witness = check_counts(out, "witness")
    view = check_counts(out, "viewshadow")
    ok = (proc.returncode == 0 and witness is not None and view is not None
          and witness["observed"] > 0 and witness["unexplained"] == 0
          and view["unexplained"] == 0)
    return {"ok": ok, "seconds": secs, "witness": witness,
            "view_shadow": view, "returncode": proc.returncode,
            **({} if ok else {"tail": _tail(proc)})}
