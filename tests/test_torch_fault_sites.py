"""The port's fault sites ``health.chip_event`` and ``prepare.drain``,
armed on the port's own registry (``tpu_dra_torch.infra.faults.FAULTS``)
and held to the degraded path each site declares: a synthetic health
event flows through the real monitor loop (skip list included) without a
backend that can mint one, and a faulted hot-restart drain dumps the
flight recorder and returns at once instead of waiting out the RPCs in
flight. The counterparts of the reference's tests in
``tests/test_e2e_prepare.py`` and ``tests/test_aio_server.py``.
"""

import threading

import pytest

from tpu_dra_torch.infra import trace
from tpu_dra_torch.infra.faults import FAULTS, Always, OneShot
from tpu_dra_torch.native import gpuinfo


@pytest.fixture(autouse=True)
def _reset_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


class TestHealthChipEvent:
    def test_synthetic_event_reaches_unhealthy_callback(self):
        from tpu_dra_torch.gpuplugin.health import DeviceHealthMonitor

        backend = gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(2))
        seen = []
        got = threading.Event()
        mon = DeviceHealthMonitor(backend,
                                  lambda e: (seen.append(e), got.set()))
        FAULTS.arm("health.chip_event", OneShot(),
                   payload=gpuinfo.HealthEvent(1, "xid", 79))
        mon.start()
        try:
            assert got.wait(3)
        finally:
            mon.stop()
        assert [(e.gpu_index, e.kind, e.code) for e in seen] == [
            (1, "xid", 79)]
        assert not mon.wedged

    def test_skip_listed_synthetic_event_is_dropped(self):
        from tpu_dra_torch.gpuplugin.health import (
            DEFAULT_SKIPPED_CODES, DeviceHealthMonitor,
        )

        backend = gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(2))
        seen = []
        skipped = sorted(DEFAULT_SKIPPED_CODES)[0]
        mon = DeviceHealthMonitor(backend, seen.append)
        FAULTS.arm("health.chip_event", OneShot(),
                   payload=gpuinfo.HealthEvent(0, "xid", skipped))
        mon.start()
        try:
            # The one-shot is spent once the loop pulled it.
            deadline = threading.Event()
            for _ in range(60):
                if FAULTS.fired("health.chip_event"):
                    break
                deadline.wait(0.05)
            backend.inject_health_event(gpuinfo.HealthEvent(1, "xid", 79))
            for _ in range(60):
                if seen:
                    break
                deadline.wait(0.05)
        finally:
            mon.stop()
        assert FAULTS.fired("health.chip_event") == 1
        assert [(e.gpu_index, e.code) for e in seen] == [(1, 79)]


class TestPrepareDrain:
    def test_faulted_drain_dumps_flight_recorder_and_returns(
            self, tmp_path, monkeypatch):
        from tpu_dra_torch.kubeletplugin.pipeline import RpcPipeline

        monkeypatch.setenv("TPU_DRA_FLIGHTRECORDER_DIR", str(tmp_path))
        monkeypatch.setattr(trace, "_last_dump_ns", {})
        p = RpcPipeline(window=2)
        ticket = p.admit(["claim-a"])   # in flight: a clean drain waits
        FAULTS.arm("prepare.drain", Always())
        before = trace.FLIGHT_DUMPS.value({"reason": "drain-faulted"})
        # The ticket is never done before the drain: a drain that waited
        # for it would run to the timeout.
        elapsed = p.drain(timeout_s=30.0)
        assert elapsed < 15.0
        assert p.draining
        assert trace.FLIGHT_DUMPS.value(
            {"reason": "drain-faulted"}) == before + 1
        assert len(list(tmp_path.glob("tpu-dra-flightrec-*.json"))) == 1
        p.done(ticket)

    def test_clean_drain_waits_for_inflight(self, tmp_path, monkeypatch):
        from tpu_dra_torch.kubeletplugin.pipeline import RpcPipeline

        monkeypatch.setenv("TPU_DRA_FLIGHTRECORDER_DIR", str(tmp_path))
        p = RpcPipeline(window=2)
        ticket = p.admit(["claim-a"])
        threading.Timer(0.3, p.done, args=(ticket,)).start()
        elapsed = p.drain(timeout_s=5.0)
        assert 0.2 < elapsed < 5.0
        assert not list(tmp_path.glob("tpu-dra-flightrec-*.json"))
