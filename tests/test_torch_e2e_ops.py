"""The port's e2e tier on the CPU (tpu_dra_torch.e2e): the chart
up/downgrade suite (tests/e2e/test_updowngrade.sh) on a two-node
SimCluster, and the runner's own contract: one JSON line per suite, a
failed suite recorded as failed with its error and the run's exit code
non-zero, never absorbed."""

import io
import json

import pytest
import torch

from tpu_dra_torch.e2e import __main__ as runner
from tpu_dra_torch.e2e.cluster import E2ECluster
from tpu_dra_torch.e2e.helpers import E2E, SuiteFailure

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests


@pytest.fixture(scope="module")
def e2e():
    up = E2ECluster().start()
    try:
        yield E2E(up)
    finally:
        up.stop()


def test_updowngrade(e2e):
    rec = runner.run_suite(e2e, "updowngrade")
    assert rec["ok"], rec.get("traceback") or rec
    assert rec["verbosity"] == ["5", "4"]


class _Failing:
    """An E2E whose cleanup raises: the suite must be recorded failed."""

    def cleanup(self):
        raise SuiteFailure("timed out (90s) waiting for: drained")


def test_failed_suite_is_recorded_failed():
    rec = runner.run_suite(_Failing(), "basics")
    assert rec["ok"] is False
    assert rec["error"].startswith("SuiteFailure: timed out")
    assert rec["seconds"] >= 0


def test_run_stops_at_a_failure_and_exits_nonzero(monkeypatch):
    """run() prints one JSON line per suite and stops at the first
    failure; main() then exits 1. The cluster is a stand-in: what is
    held is the runner's bookkeeping."""
    class Up:
        def __init__(self, card_node=False):
            self.cluster = type("C", (), {"api": None})()
            self.card_node = card_node

        def start(self):
            return self

        def stop(self):
            pass

    seen = []

    def fake_run_suite(e2e, name):
        seen.append(name)
        return {"suite": name, "ok": name != "admission", "seconds": 0.0}

    monkeypatch.setattr("tpu_dra_torch.e2e.cluster.E2ECluster", Up)
    monkeypatch.setattr(runner, "run_suite", fake_run_suite)
    monkeypatch.setattr("tpu_dra_torch.e2e.helpers.E2E.cleanup",
                        lambda self: None)
    out = io.StringIO()
    recs = runner.run(["basics", "admission", "gpu_claims"], out=out)
    assert seen == ["basics", "admission"]
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["suite"] for x in lines] == ["up", "basics", "admission"]
    assert [r["ok"] for r in recs] == [True, False]
    assert runner.main(["basics", "admission"]) == 1
    seen.clear()
    assert runner.main(["--fast", "--keep-going"]) == 1
    assert seen == list(runner.FAST)


def test_unknown_suite_refused():
    with pytest.raises(SystemExit) as e:
        runner.main(["nosuch"])
    assert e.value.code == 2
