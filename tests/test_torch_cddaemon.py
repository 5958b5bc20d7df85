"""The port's ComputeDomain daemon (tpu_dra_torch.cddaemon): the
behaviour tests of tests/test_cddaemon.py, run on the port with the
port's names, then its pure functions held against the reference's.

Behaviours: index-stable registration with gap filling, /etc/hosts +
nodes.cfg maintenance, process watchdog restarts, and the READY probe
against the real native gpu-domain-daemon, built from
tpu_dra_torch/native/src/domain_daemon.cc with c++ (cddaemon.binary).

Parity (exact): allocate_index, render_hosts_block and
write_nodes_config against tpu_dra.cddaemon's, after the name map
(test_torch_cd_api.CD_NAME_MAP), and the daemon's wire protocol
(Q -> READY peers=a/b, H <clique> <idx> -> OK) against the reference's
binary where it is built.
"""

import os
import signal
import socket
import subprocess
import time

import pytest

from test_torch_cd_api import cd_to_port
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cddaemon import binary
from tpu_dra_torch.cddaemon.computedomain import (
    ComputeDomainManager, IndexAllocationError, allocate_index,
)
from tpu_dra_torch.cddaemon.dnsnames import (
    render_hosts_block, stable_name, update_hosts_file, write_nodes_config,
)
from tpu_dra_torch.cddaemon.main import (
    DaemonRunner, discover_clique_id, flags, probe_ready,
)
from tpu_dra_torch.cddaemon.process import ProcessManager
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.k8s import COMPUTEDOMAINS, FakeCluster
from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
from tpu_dra_torch.testing import free_port

# A fabric clique id as NVML reports one: "{cluster UUID}.{clique id}".
FABRIC = "0a1b2c3d-0000-4000-8000-00000000beef.3"


def daemon_bin() -> str:
    """The native daemon of this checkout's source (built once, at the
    first test that needs it)."""
    return binary.build()


@pytest.fixture(autouse=True)
def _reset_port_registries():
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


def make_cd(cluster, name="cd-1", namespace="user-ns"):
    return cluster.create(COMPUTEDOMAINS, {
        "apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"numNodes": 2, "channel": {
            "resourceClaimTemplate": {"name": "rct"},
            "allocationMode": "Single"}},
    })


class TestIndexAllocation:
    def test_gap_filling_within_clique(self):
        nodes = [{"cliqueID": "s0", "index": 0},
                 {"cliqueID": "s0", "index": 2},
                 {"cliqueID": "s1", "index": 1}]
        assert allocate_index(nodes, "s0", 64) == 1
        assert allocate_index(nodes, "s1", 64) == 0
        assert allocate_index(nodes, "s2", 64) == 0

    def test_bound(self):
        nodes = [{"cliqueID": "s0", "index": i} for i in range(4)]
        with pytest.raises(IndexAllocationError):
            allocate_index(nodes, "s0", 4)


class TestRegistration:
    def _mgr(self, cluster, cd, node, ip, clique_id="s0"):
        return ComputeDomainManager(
            cluster, cd_name=cd["metadata"]["name"],
            cd_namespace=cd["metadata"]["namespace"],
            cd_uid=cd["metadata"]["uid"], node_name=node, node_ip=ip,
            clique_id=clique_id, max_nodes=8)

    def test_three_nodes_stable_indices(self):
        cluster = FakeCluster()
        cd = make_cd(cluster)
        mgrs = [self._mgr(cluster, cd, f"node-{c}", f"10.0.0.{i}")
                for i, c in enumerate("abc")]
        assert [m.ensure_node_info() for m in mgrs] == [0, 1, 2]
        # Re-register is idempotent.
        assert mgrs[1].ensure_node_info() == 1
        # Middle node leaves; a new node fills its gap.
        mgrs[1].remove_node_info()
        new = self._mgr(cluster, cd, "node-d", "10.0.0.9")
        assert new.ensure_node_info() == 1

    def test_heterogeneous_cliques_get_independent_indices(self):
        cluster = FakeCluster()
        cd = make_cd(cluster)
        a = self._mgr(cluster, cd, "node-a", "10.0.0.1", "clique-A")
        b = self._mgr(cluster, cd, "node-b", "10.0.0.2", "clique-B")
        assert a.ensure_node_info() == 0
        assert b.ensure_node_info() == 0
        node_set = tuple(sorted(
            (n["name"], n["ipAddress"], n["cliqueID"], n["index"])
            for n in cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")
            ["status"]["nodes"]))
        assert a.clique_peers(node_set) == [(0, "10.0.0.1")]
        assert b.clique_peers(node_set) == [(0, "10.0.0.2")]

    def test_set_node_status(self):
        cluster = FakeCluster()
        cd = make_cd(cluster)
        mgr = self._mgr(cluster, cd, "node-a", "10.0.0.1")
        mgr.ensure_node_info()
        mgr.set_node_status(True)
        nodes = cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")["status"]["nodes"]
        assert nodes[0]["status"] == "Ready"

    def test_clique_change_reallocates_index(self):
        """A node moved into another clique must not keep an index that
        collides inside the new group."""
        cluster = FakeCluster()
        cd = make_cd(cluster)
        a = self._mgr(cluster, cd, "node-a", "10.0.0.1", "clique-A")
        b = self._mgr(cluster, cd, "node-b", "10.0.0.2", "clique-B")
        a2 = self._mgr(cluster, cd, "node-a2", "10.0.0.3", "clique-A")
        assert [a.ensure_node_info(), b.ensure_node_info(),
                a2.ensure_node_info()] == [0, 0, 1]
        # node-a2 (clique-A index 1) moves to clique-B where 0 is taken.
        moved = self._mgr(cluster, cd, "node-a2", "10.0.0.3", "clique-B")
        assert moved.ensure_node_info() == 1
        nodes = cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")["status"]["nodes"]
        clique_b = {(n["name"], n["index"]) for n in nodes
                    if n["cliqueID"] == "clique-B"}
        assert clique_b == {("node-b", 0), ("node-a2", 1)}

    def test_ip_change_updates_registration(self):
        cluster = FakeCluster()
        cd = make_cd(cluster)
        mgr = self._mgr(cluster, cd, "node-a", "10.0.0.1")
        assert mgr.ensure_node_info() == 0
        mgr2 = self._mgr(cluster, cd, "node-a", "10.0.0.99")
        assert mgr2.ensure_node_info() == 0  # index stable across IP change
        nodes = cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")["status"]["nodes"]
        assert nodes[0]["ipAddress"] == "10.0.0.99"


class TestDnsNames:
    def test_hosts_block_managed(self, tmp_path):
        hosts = tmp_path / "hosts"
        hosts.write_text("127.0.0.1 localhost\n")
        assert update_hosts_file(str(hosts), [(0, "10.0.0.1"), (1, "10.0.0.2")])
        content = hosts.read_text()
        assert "127.0.0.1 localhost" in content
        assert f"10.0.0.1\t{stable_name(0)}" in content
        # Unchanged content -> no rewrite reported.
        assert not update_hosts_file(str(hosts),
                                     [(0, "10.0.0.1"), (1, "10.0.0.2")])
        # Member IP changes in place, block not duplicated.
        assert update_hosts_file(str(hosts), [(0, "10.0.0.7")])
        content = hosts.read_text()
        assert content.count("BEGIN gpu-dra") == 1
        assert "10.0.0.2" not in content

    def test_nodes_config_change_detection(self, tmp_path):
        path = str(tmp_path / "nodes.cfg")
        assert write_nodes_config(path, ["a", "b"], 7551)
        assert open(path).read() == "a:7551\nb:7551\n"
        assert not write_nodes_config(path, ["a", "b"], 7551)
        assert write_nodes_config(path, ["a"], 7551)


class TestProcessManager:
    def test_watchdog_restarts_on_unexpected_exit(self):
        pm = ProcessManager(["sleep", "60"], watchdog_interval=0.05)
        pm.ensure_started()
        try:
            assert pm.running()
            pm._proc.kill()
            deadline = time.monotonic() + 3
            while time.monotonic() < deadline and pm.restarts == 0:
                time.sleep(0.05)
            assert pm.restarts >= 1
            assert pm.running()
        finally:
            pm.stop()
        assert not pm.running()

    def test_reusable_after_stop(self):
        """stop() then ensure_started() must re-arm the watchdog."""
        pm = ProcessManager(["sleep", "60"], watchdog_interval=0.05)
        pm.ensure_started()
        pm.stop()
        pm.ensure_started()
        try:
            pm._proc.kill()
            deadline = time.monotonic() + 3
            while time.monotonic() < deadline and pm.restarts == 0:
                time.sleep(0.05)
            assert pm.restarts >= 1
        finally:
            pm.stop()

    def test_restart_and_signal(self):
        pm = ProcessManager(["sleep", "60"], watchdog_interval=10)
        pm.ensure_started()
        try:
            pid1 = pm._proc.pid
            pm.restart()
            assert pm._proc.pid != pid1
            pm.mark_ready()
            pm.signal(signal.SIGUSR1)  # sleep dies on SIGUSR1
            time.sleep(0.1)
            assert pm._proc.poll() is not None
        finally:
            pm.stop()

    def test_signal_held_until_ready(self):
        """A signal sent before the child is confirmed ready must not be
        delivered (the rc=-10 startup race): `sleep` has no
        SIGUSR1 handler, so surviving the signal proves it was held; dying
        after mark_ready() proves the held signal was then delivered."""
        pm = ProcessManager(["sleep", "60"], watchdog_interval=10)
        pm.ensure_started()
        try:
            pm.signal(signal.SIGUSR1)
            pm.signal(signal.SIGUSR1)  # coalesced, not queued twice
            time.sleep(0.2)
            assert pm.running(), "pre-ready signal reached the child"
            pm.mark_ready()
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline and pm._proc.poll() is None:
                time.sleep(0.05)
            assert pm._proc.poll() is not None, "held signal never delivered"
        finally:
            pm.stop()

    def test_stale_probe_cannot_confirm_restarted_child(self):
        """A READY probe answered by child A must not confirm child B
        spawned after the probe (mark_ready pid guard): confirming B from
        A's probe would flush held signals into B's exec window."""
        pm = ProcessManager(["sleep", "60"], watchdog_interval=10)
        pm.ensure_started()
        try:
            stale_pid = pm.pid()
            pm.restart()
            pm.mark_ready(stale_pid)  # stale confirmation: ignored
            pm.signal(signal.SIGUSR1)
            time.sleep(0.2)
            assert pm.running(), "stale probe confirmed the new child"
            pm.mark_ready(pm.pid())  # fresh confirmation delivers the hold
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline and pm._proc.poll() is None:
                time.sleep(0.05)
            assert pm._proc.poll() is not None
        finally:
            pm.stop()

    def test_restart_rearms_signal_hold(self):
        """_spawn_locked resets the ready confirmation: signals after a
        restart are held again until the next mark_ready()."""
        pm = ProcessManager(["sleep", "60"], watchdog_interval=10)
        pm.ensure_started()
        try:
            pm.mark_ready()
            pm.restart()
            pm.signal(signal.SIGUSR1)
            time.sleep(0.2)
            assert pm.running(), "post-restart signal was not held"
        finally:
            pm.stop()


class TestSupervisorBackoff:
    def test_crash_loop_backs_off_instead_of_respawn_per_tick(self):
        """A child that dies instantly must not be respawned at watchdog
        frequency: consecutive crashes grow a capped backoff."""
        pm = ProcessManager(["false"], watchdog_interval=0.02)
        pm.RESTART_BACKOFF_BASE = 0.2
        pm.ensure_started()
        try:
            time.sleep(0.5)
            # Unsupervised respawn at 0.02s ticks would reach ~25 restarts;
            # with 0.2s-base exponential backoff only a few fit in 0.5s.
            assert 1 <= pm.restarts <= 4
        finally:
            pm.stop()

    def test_ready_child_resets_crash_streak(self):
        pm = ProcessManager(["sleep", "60"], watchdog_interval=0.02)
        pm.ensure_started()
        try:
            pm._crashes = 5
            pm._next_restart_at = time.monotonic() + 99
            pm.mark_ready()
            assert pm._crashes == 0
            # Streak cleared: the next unexpected exit restarts promptly.
            pm._proc.kill()
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline and pm.restarts == 0:
                time.sleep(0.02)
            assert pm.restarts >= 1
        finally:
            pm.stop()

    def test_on_restart_hook_fires_after_respawn(self):
        import threading
        fired = threading.Event()
        pm = ProcessManager(["sleep", "60"], watchdog_interval=0.02,
                            on_restart=fired.set)
        pm.ensure_started()
        try:
            pm._proc.kill()
            assert fired.wait(2), "on_restart hook never ran"
        finally:
            pm.stop()

    def test_spawn_fault_keeps_watchdog_alive(self):
        """An injected exec failure (cddaemon.spawn) must not kill the
        watchdog thread; the respawn succeeds once the fault clears."""
        from tpu_dra_torch.infra.faults import FAULTS, OneShot

        pm = ProcessManager(["sleep", "60"], watchdog_interval=0.02)
        pm.RESTART_BACKOFF_BASE = 0.01
        pm.ensure_started()
        try:
            FAULTS.arm("cddaemon.spawn", OneShot())
            pm._proc.kill()
            # Wait on restarts, not running(): right after kill() the
            # unreaped child still reports poll() None, so running()
            # can read True before the watchdog ever saw the death.
            deadline = time.monotonic() + 3
            while time.monotonic() < deadline and pm.restarts == 0:
                time.sleep(0.02)
            assert pm.restarts >= 1, "watchdog died with the injected fault"
            assert pm.running()
            # The successful respawn was necessarily preceded by the
            # one-shot spawn failure.
            assert FAULTS.fired("cddaemon.spawn") >= 1
        finally:
            FAULTS.reset()
            pm.stop()


class TestNativeDaemon:
    def _write_cfg(self, tmp_path, port, nodes="", clique_id="s0", idx=0):
        nodes_path = tmp_path / "nodes.cfg"
        nodes_path.write_text(nodes)
        cfg = tmp_path / "daemon.cfg"
        cfg.write_text(f"node_ip=127.0.0.1\nport={port}\n"
                       f"nodes_config={nodes_path}\nclique_id={clique_id}\n"
                       f"worker_index={idx}\n")
        return str(cfg)

    def _wait_ready(self, port, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if probe_ready(port):
                return True
            time.sleep(0.05)
        return False

    def test_ready_and_peer_rendezvous(self, tmp_path):
        port_a, port_b = free_port(), free_port()
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        pm_a = ProcessManager([daemon_bin(), "--config",
                               self._write_cfg(tmp_path / "a", port_a)])
        pm_b = ProcessManager([daemon_bin(), "--config",
                               self._write_cfg(tmp_path / "b", port_b,
                                               nodes=f"127.0.0.1:{port_a}\n",
                                               idx=1)])
        pm_a.ensure_started()
        pm_b.ensure_started()
        try:
            assert self._wait_ready(port_a)
            assert self._wait_ready(port_b)

            # B dials A ("H" hello) and reports it reachable.
            def b_sees_peer():
                with socket.create_connection(("127.0.0.1", port_b), 1) as s:
                    s.sendall(b"Q\n")
                    return b"peers=1/1" in s.recv(128)
            deadline = time.monotonic() + 5
            ok = False
            while time.monotonic() < deadline and not ok:
                ok = b_sees_peer()
                time.sleep(0.1)
            assert ok
        finally:
            pm_a.stop()
            pm_b.stop()

    def test_startup_signal_hammer(self, tmp_path):
        """Hammer ensure_started + SIGUSR1 (the membership-change nudge)
        in a loop: the daemon must never die to its own reload signal.
        The startup race — SIGUSR1 landing before the daemon installed
        its handler killed the child (rc=-10) and cost a watchdog
        restart — is closed on both sides: handlers are the first
        statement of main(), and ProcessManager holds signals until the
        first READY probe confirms the child."""
        for i in range(10):
            port = free_port()
            sub = tmp_path / f"h{i}"
            sub.mkdir()
            pm = ProcessManager(
                [daemon_bin(), "--config", self._write_cfg(sub, port)],
                watchdog_interval=0.05)
            pm.ensure_started()
            try:
                # Immediately nudge, as the update loop does when the CD
                # membership lands before the daemon has booted.
                for _ in range(3):
                    pm.signal(signal.SIGUSR1)
                assert self._wait_ready(port), f"iteration {i}: never READY"
                pm.mark_ready()  # flushes held signals into the live child
                pm.signal(signal.SIGUSR1)
                time.sleep(0.1)
                assert pm.running(), f"iteration {i}: daemon died"
                assert pm.restarts == 0, (
                    f"iteration {i}: watchdog restarted ({pm.restarts}x) — "
                    "startup signal race regressed")
            finally:
                pm.stop()

    def test_idle_client_does_not_wedge_probes(self, tmp_path):
        """A connected-but-silent client (port scanner, stalled TCP) must
        not block the serve loop: --check stays READY and bounded
        (SO_RCVTIMEO on accepted fds)."""
        port = free_port()
        pm = ProcessManager([daemon_bin(), "--config",
                             self._write_cfg(tmp_path, port)])
        pm.ensure_started()
        idle = None
        try:
            assert self._wait_ready(port)
            idle = socket.create_connection(("127.0.0.1", port), 2)
            # Send nothing; wait out the 1s receive timeout so the probe
            # below isn't racing it.
            time.sleep(1.2)
            t0 = time.monotonic()
            res = subprocess.run(
                [daemon_bin(), "--check", "--port", str(port)],
                capture_output=True, text=True, timeout=10)
            elapsed = time.monotonic() - t0
            assert res.returncode == 0, res.stdout + res.stderr
            assert "READY" in res.stdout
            assert elapsed < 5.0
        finally:
            if idle is not None:
                idle.close()
            pm.stop()


class TestDaemonRunner:
    def test_end_to_end_registration_and_readiness(self, tmp_path):
        cluster = FakeCluster()
        cd = make_cd(cluster)
        port = free_port()
        ns = flags().parse([
            "--cd-uid", cd["metadata"]["uid"],
            "--cd-name", "cd-1", "--cd-namespace", "user-ns",
            "--node-name", "node-a", "--pod-ip", "127.0.0.1",
            "--port", str(port),
            "--work-dir", str(tmp_path / "work"),
            "--hosts-file", str(tmp_path / "hosts"),
            "--daemon-binary", daemon_bin(),
        ])
        runner = DaemonRunner(cluster, ns, backend=FakeBackend(
            default_fake_gpus(2, clique_id=FABRIC)))
        assert runner.clique_id == FABRIC
        runner.start()
        try:
            def node_ready():
                nodes = (cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")
                         .get("status") or {}).get("nodes") or []
                return bool(nodes) and nodes[0]["status"] == "Ready"
            assert cluster.wait_for(node_ready, timeout=10)
            nodes = cluster.get(COMPUTEDOMAINS, "cd-1",
                                "user-ns")["status"]["nodes"]
            assert nodes[0]["name"] == "node-a"
            assert nodes[0]["cliqueID"] == FABRIC
            # Membership update loop rendered hosts + nodes.cfg.
            assert cluster.wait_for(lambda: os.path.exists(
                str(tmp_path / "hosts")), timeout=5)
            hosts = open(str(tmp_path / "hosts")).read()
            assert stable_name(0) in hosts
        finally:
            runner.stop()
        # Self-removal on shutdown.
        nodes = (cluster.get(COMPUTEDOMAINS, "cd-1", "user-ns")
                 .get("status") or {}).get("nodes") or []
        assert nodes == []


class TestMemberLossSettle:
    """Member-loss handling on the daemon side: a dying clique's burst of
    member removals coalesces into one reconfigure,
    and a failed member-loss update retries instead of waiting for a
    nudge from a peer that is never coming back."""

    def _runner(self, tmp_path, monkeypatch):
        from types import SimpleNamespace

        cluster = FakeCluster()
        cd = make_cd(cluster)
        ns = flags().parse([
            "--cd-uid", cd["metadata"]["uid"],
            "--cd-name", "cd-1", "--cd-namespace", "user-ns",
            "--node-name", "node-a", "--pod-ip", "10.0.0.1",
            "--port", str(free_port()),
            "--work-dir", str(tmp_path / "work"),
            "--hosts-file", str(tmp_path / "hosts"),
            "--daemon-binary", "/nonexistent/daemon",
        ])
        runner = DaemonRunner(cluster, ns, backend=FakeBackend(
            default_fake_gpus(2, clique_id="clique-A")))
        os.makedirs(str(tmp_path / "work"), exist_ok=True)
        signals = []
        runner.process = SimpleNamespace(
            signal=lambda sig: signals.append(sig),
            restart=lambda: signals.append("restart"))
        return runner, signals

    @staticmethod
    def _members(n):
        return tuple((f"node-{i}", f"10.0.0.{i}", "clique-A", i)
                     for i in range(n))

    def test_shrink_burst_coalesces_to_one_reconfigure(
            self, tmp_path, monkeypatch):
        import threading

        runner, signals = self._runner(tmp_path, monkeypatch)
        runner.MEMBER_LOSS_SETTLE_S = 0.15
        t = threading.Thread(target=runner._update_loop, daemon=True)
        t.start()
        try:
            runner.cd.updates.put_nowait(self._members(4))
            deadline = time.monotonic() + 5
            while not signals and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(signals) == 1, "initial membership reconfigure"
            # The burst: 4 -> 3 -> 1 in quick succession (latest-wins
            # queue + the settle drain must fold it into ONE signal).
            runner.cd._on_change({"status": {"nodes": [
                {"name": n, "ipAddress": ip, "cliqueID": s, "index": i}
                for n, ip, s, i in self._members(3)]}})
            runner.cd._on_change({"status": {"nodes": [
                {"name": n, "ipAddress": ip, "cliqueID": s, "index": i}
                for n, ip, s, i in self._members(1)]}})
            deadline = time.monotonic() + 5
            while len(signals) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.3)  # would catch a second burst signal
            assert len(signals) == 2, \
                f"shrink burst must coalesce to one reconfigure: {signals}"
            hosts = open(str(tmp_path / "hosts")).read()
            assert stable_name(0) in hosts
            assert stable_name(3) not in hosts
        finally:
            runner._stop.set()
            t.join(3)

    def test_member_loss_fault_retries(self, tmp_path, monkeypatch):
        import threading

        from tpu_dra_torch.infra.faults import FAULTS, OneShot

        runner, signals = self._runner(tmp_path, monkeypatch)
        runner.MEMBER_LOSS_SETTLE_S = 0.05
        t = threading.Thread(target=runner._update_loop, daemon=True)
        t.start()
        try:
            runner.cd.updates.put_nowait(self._members(3))
            deadline = time.monotonic() + 5
            while not signals and time.monotonic() < deadline:
                time.sleep(0.01)
            with FAULTS.armed("cd.member_loss", OneShot()):
                runner.cd.updates.put_nowait(self._members(1))
                deadline = time.monotonic() + 5
                while len(signals) < 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
            assert len(signals) >= 2, \
                "member-loss update not retried past the injected fault"
            hosts = open(str(tmp_path / "hosts")).read()
            assert stable_name(2) not in hosts
        finally:
            runner._stop.set()
            t.join(3)


class TestDriverVersionGate:
    def test_version_parse_and_compare(self):
        from tpu_dra_torch.cddaemon.main import (
            dns_names_supported, parse_driver_version,
        )
        assert parse_driver_version("570.158.01") == (570, 158, 1)
        assert parse_driver_version("1.0.0-fake") == (1, 0, 0)
        assert parse_driver_version("garbage") is None
        assert dns_names_supported("570.158.01")
        assert dns_names_supported("575.51.3")
        assert not dns_names_supported("570.124.06")
        assert not dns_names_supported("unknown")

    def test_old_driver_falls_back_to_ip_mode(self, tmp_path):
        """A driver older than the gate: the update loop rewrites IPs and
        restarts the daemon instead of SIGUSR1 (legacy IP mode)."""
        import threading

        cluster = FakeCluster()
        cd = make_cd(cluster)
        ns = flags().parse([
            "--cd-uid", cd["metadata"]["uid"],
            "--cd-name", "cd-1", "--cd-namespace", "user-ns",
            "--node-name", "node-0", "--pod-ip", "10.0.0.0",
            "--work-dir", str(tmp_path / "work"),
            "--hosts-file", str(tmp_path / "hosts"),
            "--daemon-binary", "/nonexistent/daemon",
        ])
        runner = DaemonRunner(cluster, ns, backend=FakeBackend(
            default_fake_gpus(1), driver_version="550.54.15"))
        assert not runner.dns_supported
        os.makedirs(str(tmp_path / "work"))
        calls = []
        from types import SimpleNamespace
        runner.process = SimpleNamespace(
            signal=lambda sig: calls.append(sig),
            restart=lambda: calls.append("restart"))
        t = threading.Thread(target=runner._update_loop, daemon=True)
        t.start()
        try:
            runner.cd.updates.put_nowait(
                (("node-0", "10.0.0.0", "", 0),))
            deadline = time.monotonic() + 5
            while not calls and time.monotonic() < deadline:
                time.sleep(0.01)
            assert calls == ["restart"]
            assert open(runner.nodes_path).read() == "10.0.0.0:7551\n"
        finally:
            runner._stop.set()
            t.join(3)


class TestDiscoverCliqueId:
    def test_uniform(self):
        b = FakeBackend(default_fake_gpus(4, clique_id=FABRIC))
        assert discover_clique_id(b) == FABRIC

    def test_conflict_raises(self):
        gpus = (default_fake_gpus(2, clique_id=FABRIC)
                + [g for g in default_fake_gpus(4, clique_id=FABRIC + "1")
                   if g.index >= 2])
        b = FakeBackend(gpus)
        with pytest.raises(RuntimeError):
            discover_clique_id(b)

    def test_node_local_clique_is_no_domain(self):
        b = FakeBackend(default_fake_gpus(2))
        assert discover_clique_id(b) == ""


# ---------------------------------------------------------------------------
# Pure functions and the wire protocol against the reference's
# ---------------------------------------------------------------------------

ALLOC_CASES = [
    ([], "s0", 4),
    ([{"sliceID": "s0", "index": 0}, {"sliceID": "s0", "index": 2},
      {"sliceID": "s1", "index": 1}], "s0", 64),
    ([{"sliceID": "s0", "index": 0}, {"sliceID": "s0", "index": 2},
      {"sliceID": "s1", "index": 1}], "s1", 64),
    ([{"sliceID": "", "index": 0}, {"index": 1}], "", 64),
    ([{"sliceID": "s0", "index": i} for i in range(3)], "s0", 3),
]


@pytest.mark.parametrize("nodes,clique,max_nodes", ALLOC_CASES)
def test_allocate_index_matches_reference(nodes, clique, max_nodes):
    """tpu_dra.cddaemon.computedomain.allocate_index, exact: the same
    index, or the same refusal."""
    from tpu_dra.cddaemon.computedomain import (
        IndexAllocationError as RefFull, allocate_index as ref_allocate,
    )
    try:
        want = ref_allocate(nodes, clique, max_nodes)
    except RefFull:
        with pytest.raises(IndexAllocationError):
            allocate_index(cd_to_port(nodes), clique, max_nodes)
        return
    assert allocate_index(cd_to_port(nodes), clique, max_nodes) == want


@pytest.mark.parametrize("members", [
    [], [(0, "10.0.0.1")], [(2, "10.0.0.3"), (0, "10.0.0.1"),
                           (1, "10.0.0.2")]])
def test_render_hosts_block_matches_reference(members):
    """tpu_dra.cddaemon.dnsnames.render_hosts_block, exact after the
    name map (its block markers and stable names name the port's)."""
    from tpu_dra.cddaemon import dnsnames as ref_dns
    want = ref_dns.render_hosts_block(members)
    got = render_hosts_block(members)
    assert got == want.replace("tpu-dra", "gpu-dra").replace(
        "tpu-cd-daemon", "gpu-cd-daemon")


def test_write_nodes_config_matches_reference(tmp_path):
    """tpu_dra.cddaemon.dnsnames.write_nodes_config: the same bytes and
    the same change reports over one sequence of writes."""
    from tpu_dra.cddaemon import dnsnames as ref_dns
    seq = [["a", "b"], ["a", "b"], [], ["gpu-cd-daemon-0001"], ["a"]]
    ref_path, port_path = str(tmp_path / "r.cfg"), str(tmp_path / "p.cfg")
    for names in seq:
        assert write_nodes_config(port_path, names, 7551) == \
            ref_dns.write_nodes_config(ref_path, names, 7551)
        assert open(port_path).read() == open(ref_path).read()


def _ask(port, line):
    with socket.create_connection(("127.0.0.1", port), 2) as s:
        s.sendall(line)
        return s.recv(160).decode()


def _serve(binary_path, work, port, clique_key, clique, idx):
    os.makedirs(work)
    (open(os.path.join(work, "nodes.cfg"), "w")).close()
    cfg = os.path.join(work, "d.cfg")
    with open(cfg, "w") as f:
        f.write(f"node_ip=127.0.0.1\nport={port}\nnodes_config="
                f"{os.path.join(work, 'nodes.cfg')}\n{clique_key}={clique}\n"
                f"worker_index={idx}\n")
    pm = ProcessManager([binary_path, "--config", cfg])
    pm.ensure_started()
    return pm


def test_wire_protocol_matches_reference_binary(tmp_path):
    """The port's daemon answers each request of the protocol as the
    reference's native/src/slice_daemon.cc does (compiled here, with the
    port's flags, into the test's own directory; exact, after the
    clique/slice config key)."""
    ref_bin = str(tmp_path / "tpu-slice-daemon")
    subprocess.run(["c++", *binary.CXX_FLAGS, "-o", ref_bin, os.path.join(
        os.path.dirname(__file__), "..", "native", "src",
        "slice_daemon.cc")], check=True, capture_output=True, timeout=300)
    ports = free_port(), free_port()
    pms = [_serve(ref_bin, str(tmp_path / "ref"), ports[0], "slice_id",
                  "c7", 3),
           _serve(daemon_bin(), str(tmp_path / "port"), ports[1],
                  "clique_id", "c7", 3)]
    try:
        for port in ports:
            deadline = time.monotonic() + 5
            while not probe_ready(port) and time.monotonic() < deadline:
                time.sleep(0.05)
        for line in (b"Q\n", b"H c9 1\n", b"X\n"):
            assert _ask(ports[1], line) == _ask(ports[0], line), line
        assert _ask(ports[1], b"H x 0\n") == "OK c7 3\n"
    finally:
        for pm in pms:
            pm.stop()


def test_binary_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The binary's name carries the hash of its source and flags: a
    changed source is a new binary, built under the lock; a failing
    build raises with the compiler's output."""
    src = tmp_path / "d.cc"
    src.write_text(open(binary.SOURCE).read())
    monkeypatch.setattr(binary, "SOURCE", src)
    monkeypatch.setattr(binary, "BUILD_DIR", tmp_path / "build")
    first = binary.build()
    assert os.path.exists(first) and first == binary.build()
    src.write_text(src.read_text() + "\n// changed\n")
    second = binary.build()
    assert second != first and os.path.exists(second)
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="failed to build"):
        binary.build()
