"""The port's e2e tier on the CPU (tpu_dra_torch.e2e): the ComputeDomain
lifecycle and failover suites (tests/e2e/test_cd_lifecycle.sh,
test_cd_failover.sh) on one two-node SimCluster with the chart's default
render installed. Each suite is the runner's own (run_suite: cleanup,
then the suite)."""

import pytest
import torch

from tpu_dra_torch.e2e.__main__ import run_suite
from tpu_dra_torch.e2e.cluster import E2ECluster
from tpu_dra_torch.e2e.helpers import E2E

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests


@pytest.fixture(scope="module")
def e2e():
    up = E2ECluster().start()
    try:
        yield E2E(up)
    finally:
        up.stop()


def test_cd_lifecycle(e2e):
    rec = run_suite(e2e, "cd_lifecycle")
    assert rec["ok"], rec.get("traceback") or rec
    assert sorted(e["NODE_RANK"] for e in rec["envs"].values()) == ["0", "1"]


def test_cd_failover(e2e):
    rec = run_suite(e2e, "cd_failover")
    assert rec["ok"], rec.get("traceback") or rec
    assert rec["fault_status"] in ("NotReady", "Degraded")
