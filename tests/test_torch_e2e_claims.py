"""The port's e2e tier on the CPU (tpu_dra_torch.e2e): the GPU-claims,
stress, multiprocess and health suites (tests/e2e/test_tpu_claims.sh,
test_stress.sh, test_multiprocess.sh, test_health.sh) on one two-node
SimCluster with the chart's default render installed. The training pod
of gpu-test1 runs `bench claim-child --device-type cpu` at a small
width. Each suite is the runner's own (run_suite: cleanup, then the
suite)."""

import math

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


def _ok(e2e, suite):
    rec = run_suite(e2e, suite)
    assert rec["ok"], rec.get("traceback") or rec
    return rec


def test_gpu_claims(e2e):
    rec = _ok(e2e, "gpu_claims")
    train = rec["train"]
    assert train["steps"] == 2 and all(math.isfinite(x)
                                       for x in train["losses"])
    assert rec["demos"] == [f"gpu-test{i}" for i in range(1, 7)]


def test_stress(e2e):
    rec = _ok(e2e, "stress")
    assert len(rec["loop_s"]) == rec["stress_loops"]
    assert rec["churn_p95_s"] == sorted(rec["loop_s"])[
        int(0.95 * (len(rec["loop_s"]) - 1))]


@pytest.mark.parametrize("suite", ["multiprocess", "health"])
def test_suite(e2e, suite):
    _ok(e2e, suite)
