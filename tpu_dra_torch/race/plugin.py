"""The port's session-wide lock-order witness and view shadow, as a
pytest plugin:

    TPU_DRA_VIEW_SHADOW=1 TPU_DRA_TORCH_RACE_EDGES=edges.json \\
    TPU_DRA_TORCH_RACE_DRIFTS=drifts.json \\
        python -m pytest -p tpu_dra_torch.race.plugin tests/test_torch_*.py

The counterpart of the witness block of tests/conftest.py, which
installs only the reference's witness. At import (``-p`` loads it
before any test module) it installs ``tpu_dra_torch.infra.lockwitness``,
so the port's module-level locks are witnessed too. At the session's
end it verifies the port's view shadow (``tpu_dra_torch.k8s.informer
.SHADOW``, on under ``TPU_DRA_VIEW_SHADOW=1``), merges the observed
edges into the file ``TPU_DRA_TORCH_RACE_EDGES`` names and the drifts
into ``TPU_DRA_TORCH_RACE_DRIFTS`` (each skipped when unset), and sets
the exit status to 3 on a lock-order cycle or a drift.

Leave ``TPU_DRA_LOCK_WITNESS`` unset with this plugin: conftest would
install the reference's witness as well, which keys every path holding
``tpu_dra``, this package's too. Hooks are plain functions; the module
imports neither pytest nor the reference.
"""

from __future__ import annotations

import os

from tpu_dra_torch.infra import lockwitness
from tpu_dra_torch.race import DRIFTS_ENV, EDGES_ENV

CYCLE_OR_DRIFT = 3

lockwitness.install()


def pytest_sessionfinish(session, exitstatus):
    from tpu_dra_torch.k8s import informer

    # Every drift of the session, also those a harness already verified.
    drifts = informer.SHADOW.violations_since(0)
    if os.environ.get(DRIFTS_ENV):
        informer.SHADOW.export(os.environ[DRIFTS_ENV])
    if os.environ.get(EDGES_ENV):
        lockwitness.export_edges(os.environ[EDGES_ENV])
    cycles = lockwitness.WITNESS.cycles()
    if drifts:
        print("\n!! tpu_dra_torch view shadow:")
        for d in drifts:
            print(f"   {d}")
    if cycles:
        print("\n!! lock-order witness cycles (tpu_dra_torch):")
        for c in cycles:
            print(f"   {c}")
    if drifts or cycles:
        session.exitstatus = CYCLE_OR_DRIFT
