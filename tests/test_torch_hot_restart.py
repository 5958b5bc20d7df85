"""The plugin's hot restart, masked by the client: tpu_dra_torch's
RetryingFramedClient and bench_hot_restart, on the CPU over the fake
8-GPU node.

Held against the contract the reference states in RetryingFramedClient's
docstring and in bench_hot_restart (tpu_dra/kubeletplugin/server.py,
bench.py): zero failed RPCs across restarts, at least one reconnect per
restart, the journal's claims recovered by the next incarnation and none
leaked; a drain refusal, a socket gap and a refused dial are retried, any
other server error is not; the ``prepare.reconnect`` fault site degrades
to the same backoff.
"""

import threading
import time

import pytest
import torch

from tpu_dra_torch import bench
from tpu_dra_torch.infra.faults import FAULTS, EveryNth
from tpu_dra_torch.kubeletplugin import server, wire
from tpu_dra_torch.kubeletplugin.server import (
    RPC_RECONNECTS, FramedClient, FramedRpcError, RetryingFramedClient,
)
from tpu_dra_torch.native import gpuinfo

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


@pytest.fixture
def node():
    bd = bench._BenchDriver(gpuinfo.FakeBackend(
        gpuinfo.default_fake_gpus(4)))
    yield bd
    bd.close()


def _claims(bd, n, tag):
    objs = [bench._make_claim(bd.cluster, [i % len(bd.gpus)], f"{tag}-{i}")
            for i in range(n)]
    return objs, bd._request(objs)


def test_bench_hot_restart_contract():
    res = bench.bench_hot_restart(
        gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(6)), duration_s=2.0,
        workers=3, gpus_per_worker=2, n_restarts=2)
    assert res["hot_restart_failed_rpcs"] == 0, \
        res.get("hot_restart_first_error")
    assert res["hot_restart_leaked_claims"] == 0
    assert res["hot_restart_reconnects"] >= res["hot_restart_restarts"] == 2
    per_restart = res["hot_restart_reconnects_per_restart"]
    assert len(per_restart) == 2 and min(per_restart) >= 1, per_restart
    assert sum(per_restart) <= res["hot_restart_reconnects"]
    assert res["hot_restart_rpcs"] > 0
    assert len(res["hot_restart_drain_s"]) == 2
    assert res["hot_restart_p99_ms"] >= res["hot_restart_p50_ms"] > 0


def test_restart_mid_batch_masked_and_journal_recovered(node):
    """Batches of four claims prepared and unprepared flat-out on one
    client while the plugin restarts under them: no RPC fails, the
    client reconnected; claims left prepared across a restart are
    recovered from the journal, and unprepared after it."""
    _, batch = _claims(node, 4, "batch")
    kept_objs, kept = _claims(node, 2, "kept")
    client = RetryingFramedClient(node.driver.server.fast_socket,
                                  timeout_s=30.0)
    errors, rpcs = [], [0]
    stop = threading.Event()

    def loop():
        try:
            while not stop.is_set():
                for req in (wire.NodePrepareResourcesRequest(claims=batch),
                            wire.NodeUnprepareResourcesRequest(
                                claims=batch)):
                    resp = (client.prepare if isinstance(
                        req, wire.NodePrepareResourcesRequest)
                        else client.unprepare)(req)
                    rpcs[0] += 1
                    errors.extend(r.error for r in resp.claims.values()
                                  if r.error)
        except Exception as e:  # noqa: BLE001 — a failed RPC
            errors.append(repr(e))

    kept_client = RetryingFramedClient(node.driver.server.fast_socket)
    resp = kept_client.prepare(wire.NodePrepareResourcesRequest(claims=kept))
    assert not any(r.error for r in resp.claims.values())
    def wait_rpcs(n):
        deadline = time.monotonic() + 60
        while rpcs[0] < n and t.is_alive() and time.monotonic() < deadline:
            time.sleep(0.001)

    t = threading.Thread(target=loop)
    t.start()
    try:
        wait_rpcs(4)
        _, recovered = node.hot_restart()
        n_before = rpcs[0]
        wait_rpcs(n_before + 4)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    assert errors == []
    assert rpcs[0] >= n_before + 4
    assert client.reconnects >= 1
    assert recovered >= len(kept)
    kept_uids = {o["metadata"]["uid"] for o in kept_objs}
    assert kept_uids <= set(node.state.prepared_claim_uids())
    resp = kept_client.unprepare(
        wire.NodeUnprepareResourcesRequest(claims=kept))
    assert not any(r.error for r in resp.claims.values())
    assert kept_client.reconnects >= 1   # its old connection died too
    assert node.state.prepared_claim_uids() == []
    client.close()
    kept_client.close()


def test_reconnect_fault_degrades_to_backoff(node):
    """prepare.reconnect fires on the first two dials: the client backs
    off and redials, the RPC succeeds, each refused dial is one counted
    reconnect."""
    before = RPC_RECONNECTS.value()
    calls = []

    def refuse_twice(**ctx):
        calls.append(ctx)
        if len(calls) <= 2:
            raise server.FaultInjected("prepare.reconnect")

    FAULTS.arm("prepare.reconnect", EveryNth(1), action=refuse_twice)
    client = RetryingFramedClient(node.driver.server.fast_socket,
                                  backoff_s=0.01)
    assert client.ping()
    assert client.reconnects == 2
    assert RPC_RECONNECTS.value() - before == 2
    assert calls[0]["socket"] == node.driver.server.fast_socket
    client.close()


class FakeClock:
    """A monotonic clock that only `sleep` advances: the client's
    deadline and backoff then run the same on any host."""

    def __init__(self):
        self.now = 0.0
        self.slept = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.slept.append(s)
        self.now += s


# max_elapsed_s 0.3 and backoff 0.05, doubling: dials at 0, 0.05, 0.15
# and 0.35; the fourth fails past the deadline and is raised.
DEADLINE_S, BACKOFF_S = 0.3, 0.05
DIALS_AT = [0.0, 0.05, 0.15, 0.35]


def _deadline_client(sock, clock):
    return RetryingFramedClient(sock, max_elapsed_s=DEADLINE_S,
                                backoff_s=BACKOFF_S, clock=clock.monotonic,
                                sleep=clock.sleep)


def _stopped_at_the_deadline(client, clock, dials):
    """Every failure before the deadline was retried after one backoff,
    and the first one at or past it was raised."""
    assert dials == pytest.approx(DIALS_AT)
    assert client.reconnects == len(DIALS_AT) - 1
    assert clock.slept == pytest.approx([0.05, 0.1, 0.2])
    assert dials[-2] < DEADLINE_S <= dials[-1] == clock.now


def test_reconnect_fault_bounded_by_deadline(node):
    clock = FakeClock()
    dials = []

    def refuse(**ctx):
        dials.append(clock.now)
        raise server.FaultInjected("prepare.reconnect")

    FAULTS.arm("prepare.reconnect", EveryNth(1), action=refuse)
    client = _deadline_client(node.driver.server.fast_socket, clock)
    with pytest.raises(server.FaultInjected):
        client.ping()
    _stopped_at_the_deadline(client, clock, dials)


def test_only_the_drain_refusal_is_retried(node, monkeypatch):
    seen = []

    def prepare(self, request):
        seen.append(1)
        if len(seen) <= 2:
            raise FramedRpcError("plugin draining for hot restart; "
                                 "retry after reconnect")
        return "ok"

    monkeypatch.setattr(FramedClient, "prepare", prepare)
    client = RetryingFramedClient(node.driver.server.fast_socket,
                                  backoff_s=0.01)
    assert client.prepare(None) == "ok"
    assert client.reconnects == 2

    def broken(self, request):
        raise FramedRpcError("boom")

    monkeypatch.setattr(FramedClient, "prepare", broken)
    client = RetryingFramedClient(node.driver.server.fast_socket)
    with pytest.raises(FramedRpcError, match="boom"):
        client.prepare(None)
    assert client.reconnects == 0


def test_gap_without_a_server_raises_at_the_deadline(tmp_path,
                                                     monkeypatch):
    clock = FakeClock()
    dials = []
    dial = FramedClient.__init__

    def counted(self, *args, **kwargs):
        dials.append(clock.now)
        dial(self, *args, **kwargs)

    monkeypatch.setattr(FramedClient, "__init__", counted)
    client = _deadline_client(str(tmp_path / "none.sock"), clock)
    with pytest.raises(OSError):
        client.ping()
    _stopped_at_the_deadline(client, clock, dials)
