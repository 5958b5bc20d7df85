"""ComputeDomain daemon entrypoint: ``run`` and ``check`` subcommands
(counterpart of tpu_dra/cddaemon/main.py).

``run``: write the native daemon's config with the pod IP, register this
node into the CD status, spawn the update loop + process watchdog;
membership changes rewrite /etc/hosts + nodes.cfg and SIGUSR1 the daemon
(DNS-names mode) or rewrite IPs and restart it (legacy IP mode).
``check``: the local readiness probe — READY or exit 1.

The domain daemon runs on every member, including the ones with no
NVLink clique (cliqueID ""): it is a rendezvous/health server with no
fabric side effects, so those members get the same probe path with an
empty peer list of their own clique.

Run: ``python -m tpu_dra_torch.cddaemon.main run|check [flags]``
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import socket
import sys
import threading
from typing import Optional

from tpu_dra_torch.cddaemon import binary
from tpu_dra_torch.cddaemon.computedomain import ComputeDomainManager
from tpu_dra_torch.cddaemon.dnsnames import (
    stable_name, update_hosts_file, write_nodes_config,
)
from tpu_dra_torch.cddaemon.process import ProcessManager
from tpu_dra_torch.infra import debug, featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.flags import (
    Flag, FlagSet, apply_feature_gates, feature_gate_flag, logging_flags,
    setup_logging,
)
from tpu_dra_torch.k8s.client import HttpApiClient, RetryingApiClient
from tpu_dra_torch.native.gpuinfo import get_backend

log = logging.getLogger("tpu_dra_torch.cddaemon")

DEFAULT_PORT = 7551

# DNS-stable rendezvous is gated on the GPU driver version from which
# NVIDIA's own compute-domain daemon re-resolves peer names on SIGUSR1.
MIN_DNS_DRIVER_VERSION = (570, 158, 1)


def parse_driver_version(raw: str):
    """'1.2.3-suffix' -> (1, 2, 3); unparseable -> None."""
    parts = raw.split("-")[0].split(".")
    try:
        return tuple(int(p) for p in parts[:3])
    except ValueError:
        return None


def dns_names_supported(raw_version: str) -> bool:
    parsed = parse_driver_version(raw_version)
    return parsed is not None and parsed >= MIN_DNS_DRIVER_VERSION


def _default_daemon_binary() -> str:
    """$GPU_DRA_DOMAIN_DAEMON, else this checkout's build of the current
    source (binary.build makes it), else the installed binary's name."""
    candidates = [
        os.environ.get("GPU_DRA_DOMAIN_DAEMON", ""),
        str(binary.binary_path()),
        f"/usr/local/bin/{binary.BINARY}",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return os.path.abspath(c)
    return binary.BINARY


def flags() -> FlagSet:
    return FlagSet("gpu-cd-daemon", [
        Flag("cd-uid", "CD_UID", required=True,
             help="UID of the ComputeDomain this daemon belongs to"),
        Flag("cd-name", "CD_NAME", required=True, help="ComputeDomain name"),
        Flag("cd-namespace", "CD_NAMESPACE", required=True,
             help="ComputeDomain namespace"),
        Flag("node-name", "NODE_NAME", required=True, help="node name"),
        Flag("pod-ip", "POD_IP", required=True, help="this pod's IP"),
        Flag("port", "DOMAIN_DAEMON_PORT", default=DEFAULT_PORT, type=int,
             help="domain daemon rendezvous/status port"),
        Flag("work-dir", "WORK_DIR", default="/var/run/gpu-dra-cd",
             help="config/state directory"),
        Flag("hosts-file", "HOSTS_FILE", default="/etc/hosts",
             help="hosts file managed for stable peer names"),
        Flag("daemon-binary", "DOMAIN_DAEMON_BINARY",
             default=_default_daemon_binary(),
             help="path to the native gpu-domain-daemon"),
        Flag("max-nodes-per-clique-domain", "MAX_NODES_PER_CLIQUE_DOMAIN",
             default=64, type=int, help="index allocation bound"),
        Flag("kube-api-url", "KUBE_API_URL", default=None,
             help="API server URL (default: in-cluster config)"),
        feature_gate_flag(),
        *logging_flags(),
    ])


def domain_clique_id(gpu) -> str:
    """A GPU's clique as the domain sees it: a fabric clique id
    ("{cluster UUID}.{clique id}", a multi-node NVLink domain) is kept;
    the node-local clique (id "": active NVLinks, no fabric id) and a GPU
    that is a clique of its own (its UUID: no active NVLink) read as "",
    a member that reaches the domain's other nodes over the network only.
    Two HGX nodes without a fabric manager then never share a clique."""
    cid = gpu.clique_id
    return "" if not cid or cid == gpu.uuid else cid


def discover_clique_id(backend) -> str:
    """The node's clique identity: every GPU on the node must agree on it
    (domain_clique_id); '' = not in a multi-node NVLink domain."""
    ids = {domain_clique_id(g) for g in backend.gpus()}
    if not ids:
        return ""
    if len(ids) > 1:
        raise RuntimeError(
            f"GPUs disagree on clique identity: {sorted(ids)}")
    return ids.pop()


class DaemonRunner:
    """Wires CD registration, the native process, and the update loop;
    factored as a class so tests can drive it without a real pod."""

    # Member-loss settle: a dying clique produces a BURST of removals
    # (one CD status write per departing daemon). Reconfiguring the
    # native daemon per removal means N hosts-file rewrites and — in
    # legacy IP mode — N full child restarts in quick succession, a
    # self-inflicted crash loop on every surviving node exactly when
    # the domain is most fragile. Shrinks therefore wait this long and
    # drain to the LATEST membership snapshot before reconfiguring:
    # one burst, one reconfigure. Growth stays immediate (a joining
    # member should rendezvous at probe latency).
    MEMBER_LOSS_SETTLE_S = 0.25

    def __init__(self, client, ns, backend=None):
        """backend: the node's GPU discovery (default get_backend(): NVML
        unless the environment asks for the fake)."""
        self.ns = ns
        self.client = client
        self.backend = backend if backend is not None else get_backend()
        gpus = self.backend.gpus()
        self.clique_id = discover_clique_id(self.backend)
        # Version-gate input, captured once. GPU-less members have no
        # driver to impose the constraint — treat DNS mode as supported
        # there.
        self.dns_supported = (
            not gpus or dns_names_supported(self.backend.driver_version()))
        self.cd = ComputeDomainManager(
            client, cd_name=ns.cd_name, cd_namespace=ns.cd_namespace,
            cd_uid=ns.cd_uid, node_name=ns.node_name, node_ip=ns.pod_ip,
            clique_id=self.clique_id,
            max_nodes=ns.max_nodes_per_clique_domain)
        self.config_path = os.path.join(ns.work_dir, "domain-daemon.cfg")
        self.nodes_path = os.path.join(ns.work_dir, "nodes.cfg")
        self.process = ProcessManager(
            [ns.daemon_binary, "--config", self.config_path],
            on_restart=self._on_daemon_restart)
        self._stop = threading.Event()
        self._threads = []
        self._last_ready = None

    # -- setup --------------------------------------------------------------

    def write_config(self, index: int) -> None:
        os.makedirs(self.ns.work_dir, exist_ok=True)
        with open(self.config_path, "w") as f:
            f.write(f"node_ip={self.ns.pod_ip}\n"
                    f"port={self.ns.port}\n"
                    f"nodes_config={self.nodes_path}\n"
                    f"clique_id={self.clique_id}\n"
                    f"worker_index={index}\n")

    def start(self) -> None:
        self.cd.start()
        index = self.cd.ensure_node_info()
        log.info("registered node %s (clique %r, index %d)",
                 self.ns.node_name, self.clique_id, index)
        self.write_config(index)
        write_nodes_config(self.nodes_path, [], self.ns.port)
        self.process.ensure_started()
        self._threads = [
            threading.Thread(target=self._update_loop, daemon=True,
                             name="cd-update-loop"),
            threading.Thread(target=self._readiness_loop, daemon=True,
                             name="cd-readiness"),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3)
        self.process.stop()
        try:
            self.cd.remove_node_info()
        except Exception:  # noqa: BLE001 — still stop the informer below
            log.exception("deregistration failed; stale entry will be "
                          "cleaned by the controller's pod-delete handler")
        self.cd.stop()

    def _on_daemon_restart(self) -> None:
        """Supervisor hook: a crashed domain daemon was respawned. Force
        the readiness mirror pessimistic NOW — workloads gating on the CD
        channel must not ride a Ready status backed by a daemon that just
        died — and drop the loop back to its fast startup cadence so the
        recovered daemon republishes Ready at probe latency.

        Publish BEFORE updating _last_ready: clearing the marker first
        opens a race where the (now fast-cadence) readiness loop probes
        the new child ready, publishes True and records it, and this
        hook's delayed False write lands last — wedging the mirror at
        False with nothing left to notice the mismatch. With the write
        first, whatever order the two publishes land in, the next loop
        tick sees marker != probe and reconverges."""
        try:
            self.cd.set_node_status(False)
            self._last_ready = False
        except Exception:  # noqa: BLE001 — the readiness loop retries
            log.exception("post-restart readiness republish failed")
            self._last_ready = None  # force a republish on the next tick

    # -- loops --------------------------------------------------------------

    def _update_loop(self) -> None:
        """Membership changes -> peer config refresh.

        Member LOSS (the peer set shrank — a node died, a clique is
        going away) is handled with a settle window + latest-snapshot
        drain (MEMBER_LOSS_SETTLE_S) so a dying clique's burst of
        removals coalesces into ONE reconfigure instead of a restart
        storm; a failed update re-offers its snapshot to the latest-wins
        queue so the loop RETRIES instead of waiting for the next
        membership change that may never come (the dead peer is not
        coming back to nudge us)."""
        dns_mode = featuregates.enabled(
            featuregates.DomainDaemonsWithDNSNames)
        if dns_mode and not self.dns_supported:
            # Version gate: fall back to legacy IP mode on drivers that
            # predate SIGUSR1 re-resolve.
            log.warning("GPU driver predates DNS-stable rendezvous; "
                        "falling back to IP mode")
            dns_mode = False
        prev_ids: Optional[set] = None
        while not self._stop.is_set():
            try:
                node_set = self.cd.updates.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                peers = self.cd.clique_peers(node_set)
                ids = {i for i, _ip in peers}
                if prev_ids is not None and prev_ids - ids:
                    # Injection site: the member-loss reconfigure path
                    # fails (hosts rewrite EIO, restart refusal) — the
                    # re-offer below must retry it; surviving daemons
                    # must not crash-loop or silently keep dead peers.
                    FAULTS.check("cd.member_loss",
                                 node=self.ns.node_name,
                                 lost=sorted(prev_ids - ids))
                    self._stop.wait(self.MEMBER_LOSS_SETTLE_S)
                    node_set, peers, ids = self._drain_latest(
                        node_set, peers, ids)
                if dns_mode:
                    hosts_changed = update_hosts_file(
                        self.ns.hosts_file, peers)
                    names = [stable_name(i) for i, _ip in sorted(peers)]
                    cfg_changed = write_nodes_config(
                        self.nodes_path, names, self.ns.port)
                    if hosts_changed or cfg_changed:
                        self.process.signal(signal.SIGUSR1)
                else:
                    ips = [ip for _i, ip in sorted(peers)]
                    if write_nodes_config(self.nodes_path, ips, self.ns.port):
                        self.process.restart()
                prev_ids = ids
            except Exception:  # noqa: BLE001 — keep consuming updates,
                # and RETRY this snapshot: put it back unless a newer
                # one already superseded it (latest-wins), then back off
                # a tick so a hard failure cannot spin the loop.
                log.exception("membership update failed; retrying")
                try:
                    self.cd.updates.put_nowait(node_set)
                except queue.Full:
                    pass  # newer snapshot queued: it wins
                self._stop.wait(0.1)

    def _drain_latest(self, node_set, peers, ids):
        """Collapse whatever queued during the settle window to the
        newest membership snapshot (one burst, one reconfigure)."""
        while True:
            try:
                node_set = self.cd.updates.get_nowait()
            except queue.Empty:
                break
            peers = self.cd.clique_peers(node_set)
            ids = {i for i, _ip in peers}
        return node_set, peers, ids

    def _readiness_loop(self) -> None:
        """Probe the local daemon and mirror readiness into the per-node CD
        status (the startup-probe mirror).

        Adaptive cadence, like a kubelet startupProbe with a small period
        vs. the steady-state readinessProbe: while NOT ready (startup, or
        after a watchdog restart) probe every 50ms so workload claims
        blocked on the readiness dance release at probe latency — a fixed
        1s tick was the single largest term of CD convergence (bench
        cd_convergence ~1.0s of which ~0.9s was waiting for this mirror).
        Once ready, 1s is plenty to notice a died daemon."""
        while not self._stop.wait(0.05 if not self._last_ready else 1.0):
            probed_pid = self.process.pid()
            ready = probe_ready(self.ns.port)
            if ready:
                # Unblocks held SIGUSR1s (process.py): the native daemon
                # answered a probe, so its signal handlers are installed.
                # Every tick, not on-change: a watchdog restart resets the
                # hold and the port coming back looks like no change. The
                # pid snapshot stops a probe answered by a since-restarted
                # child from confirming its replacement mid-exec.
                self.process.mark_ready(probed_pid)
            if ready != self._last_ready:
                try:
                    self.cd.set_node_status(ready)
                    self._last_ready = ready
                except Exception:  # noqa: BLE001 — retried next tick
                    log.exception("node status update failed")


def probe_ready(port: int, host: str = "127.0.0.1",
                timeout: float = 1.0) -> bool:
    """The `gpu-domain-daemon --check` probe, from Python."""
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.settimeout(timeout)
            s.sendall(b"Q\n")
            return s.recv(128).startswith(b"READY")
    except OSError:
        return False


def run(argv=None) -> int:
    fs = flags()
    ns = fs.parse(argv)
    logger = setup_logging(ns.v, ns.log_json)
    apply_feature_gates(ns)
    fs.dump_config(ns, logger)
    debug.start_debug_signal_handlers()

    # Transient API-server failures (rolling upgrade, LB blips)
    # retry with jittered backoff instead of crash-looping the pod.
    client = RetryingApiClient(HttpApiClient(base_url=ns.kube_api_url))
    # The daemon reads the node's NVLink fabric: every GPU of the node,
    # not the share a container runtime's CUDA_VISIBLE_DEVICES names (a
    # host whose NVML withholds PCI bus ids has them mapped through
    # CUDA, which that variable would hide).
    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    runner = DaemonRunner(client, ns)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    runner.start()
    logger.info("cd daemon running (cd %s/%s)", ns.cd_namespace, ns.cd_name)
    stop.wait()
    runner.stop()
    return 0


def check(argv=None) -> int:
    port = int(os.environ.get("DOMAIN_DAEMON_PORT", str(DEFAULT_PORT)))
    if argv:
        for i, a in enumerate(argv):
            if a == "--port" and i + 1 < len(argv):
                port = int(argv[i + 1])
    ok = probe_ready(port)
    print("READY" if ok else "NOT_READY")
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("run", "check"):
        print("usage: tpu_dra_torch.cddaemon.main run|check [flags]",
              file=sys.stderr)
        return 2
    return run(argv[1:]) if argv[0] == "run" else check(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
