"""Stand-ins for what a GPU node has around the kubelet plugin
(counterpart of the parts of tpu_dra/testing.py the device plane uses).

- ``MpsNodeSim`` plays kubelet for the per-claim MPS control-daemon
  Deployments (``gpuplugin.sharing.MpsManager``): it runs the pod's
  container command with the hostPath substituted for the container
  path, sets ``readyReplicas`` to 1 only while the readiness probe
  passes, and on deletion runs the preStop hook and kills the process.
  ``binary`` is the argv that stands for ``nvidia-cuda-mps-control``:
  the real one on a GPU node, ``MPS_STANDIN`` on the CPU.
- ``MPS_STANDIN`` runs this file as a small stand-in for
  ``nvidia-cuda-mps-control`` that honours the same contract: ``-f``
  serves a control socket in ``$CUDA_MPS_PIPE_DIRECTORY`` in the
  foreground and logs its env to ``$CUDA_MPS_LOG_DIRECTORY/control.log``;
  without arguments it sends each line of stdin to that socket and exits
  non-zero where nothing answers. It starts no MPS server.
- ``make_fake_pci_tree`` writes the sysfs, /dev and /proc a passthrough
  rebind touches for a set of GPUs under a root, and the PciSysfs of
  ``kernel_pci_sysfs`` applies the kernel's bind and unbind semantics to
  that tree at the moment each file is written, so a rebind takes only
  where the exact files were written, with no thread and no wait.
- The multi-node ComputeDomain harness (counterpart of the reference
  harness's FakeNode and provision_multi_node_cd): ``FakeNode`` is one
  node's CD kubelet plugin plus, once the node is labeled, a domain
  daemon wrapping the real native binary (``cddaemon.binary.build``);
  ``DomainSim`` runs the controller and the nodes over one FakeCluster
  and plays the scheduler, kubelet and the DaemonSet for a domain's
  channel claims; ``provision_multi_node_cd`` provisions an N-node
  domain through it and returns each node's channel-claim env;
  ``run_nodes`` runs one launcher process per simulated node.
  Simulated nodes discover fake GPUs (a FakeBackend passed to each node
  explicitly); a node given a NativeBackend discovers the host's GPUs.
- The scheduler's inventory (counterpart of the reference's
  seed_sched_inventory and make_sched_pod): fake GPU nodes publishing
  ResourceSlices with the plugin's attribute set, the ``gpu.dev``
  DeviceClass, the ``tmpl``/``tmpl<n>`` claim templates and pods that
  claim through them.

This module imports only the standard library at module level, so that
``python tpu_dra_torch/testing.py`` runs as the stand-in.
"""

from __future__ import annotations

import logging
import os
import shlex
import socket
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

MPS_STANDIN = [sys.executable, os.path.abspath(__file__)]

log = logging.getLogger("tpu_dra_torch.testing")


# ---------------------------------------------------------------------------
# MPS control daemon: node sim and stand-in
# ---------------------------------------------------------------------------

class MpsNodeSim:
    """Plays kubelet for MPS control-daemon Deployments in `namespace`."""

    def __init__(self, cluster, namespace: str,
                 binary: Optional[Sequence[str]] = None,
                 interval: float = 0.05):
        from tpu_dra_torch.gpuplugin.sharing import MPS_CONTROL

        self._cluster = cluster
        self._namespace = namespace
        self._binary = list(binary) if binary else [MPS_CONTROL]
        self._interval = interval
        self.processes: Dict[str, subprocess.Popen] = {}
        self._pods: Dict[str, Dict] = {}   # name -> {env, container}
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MpsNodeSim":
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mps-node-sim")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for name in list(self.processes):
            self._reap(name)

    def host_dir(self, name: str) -> Optional[str]:
        pod = self._pods.get(name)
        return pod["host_dir"] if pod else None

    def env(self, name: str) -> Dict[str, str]:
        """The daemon's env as launched (container paths substituted)."""
        return dict(self._pods[name]["env"])

    # -- kubelet loop -------------------------------------------------------

    def _run(self) -> None:
        from tpu_dra_torch.gpuplugin.sharing import MPS_APP_LABEL
        from tpu_dra_torch.k8s import DEPLOYMENTS

        sel = f"app.kubernetes.io/name={MPS_APP_LABEL}"
        while not self._stop.wait(self._interval):
            try:
                deps = self._cluster.list(DEPLOYMENTS, self._namespace,
                                          label_selector=sel)
            except Exception:  # noqa: BLE001 — the next tick retries
                continue
            seen = set()
            for dep in deps:
                name = dep["metadata"]["name"]
                seen.add(name)
                try:
                    proc = self.processes.get(name)
                    if proc is None:
                        self._launch(dep)
                    elif proc.poll() is None:
                        self._set_ready(dep, self._probe(name))
                    else:
                        self._set_ready(dep, False)
                except Exception:  # noqa: BLE001 — the next tick retries
                    log.warning("MPS node sim: pod %s", name, exc_info=True)
            for name in list(self.processes):
                if name not in seen:
                    self._reap(name)

    def _substitute(self, text: str, host_dir: str,
                    mount_path: str) -> str:
        """Container view -> host view: the mount path becomes the host
        directory, the daemon binary becomes `binary`."""
        from tpu_dra_torch.gpuplugin.sharing import MPS_CONTROL

        if text == mount_path or text.startswith(mount_path + "/"):
            text = host_dir + text[len(mount_path):]
        else:
            text = text.replace(mount_path + "/", host_dir + "/")
        return text.replace(MPS_CONTROL, shlex.join(self._binary))

    def _launch(self, dep: Dict) -> None:
        spec = dep["spec"]["template"]["spec"]
        container = spec["containers"][0]
        mount = next(m for m in container["volumeMounts"]
                     if m["name"] == "mps")
        host_dir = next(v["hostPath"]["path"] for v in spec["volumes"]
                        if v["name"] == "mps")
        mount_path = mount["mountPath"]
        env = {e["name"]: self._substitute(e["value"], host_dir, mount_path)
               for e in container.get("env", [])}
        command = list(container["command"])
        argv = self._binary + [self._substitute(a, host_dir, mount_path)
                               for a in command[1:]]
        name = dep["metadata"]["name"]
        self._pods[name] = {"host_dir": host_dir, "mount_path": mount_path,
                            "env": env, "container": container}
        self.processes[name] = subprocess.Popen(
            argv, env={**os.environ, **env}, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def _exec(self, name: str, command: List[str]) -> int:
        pod = self._pods[name]
        argv = [self._substitute(a, pod["host_dir"], pod["mount_path"])
                for a in command]
        res = subprocess.run(argv, env={**os.environ, **pod["env"]},
                             stdin=subprocess.DEVNULL,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL, timeout=30)
        return res.returncode

    def _probe(self, name: str) -> bool:
        probe = self._pods[name]["container"]["readinessProbe"]
        return self._exec(name, probe["exec"]["command"]) == 0

    def _reap(self, name: str) -> None:
        """Kubelet deleting the pod: the preStop hook, then SIGTERM, then
        SIGKILL after a grace period."""
        proc = self.processes.pop(name)
        pod = self._pods.pop(name, None)
        if proc.poll() is None and pod is not None:
            hook = ((pod["container"].get("lifecycle") or {})
                    .get("preStop") or {}).get("exec")
            if hook:
                self._pods[name] = pod
                try:
                    self._exec(name, hook["command"])
                except Exception:  # noqa: BLE001 — kubelet goes on
                    log.warning("MPS node sim: preStop of %s", name,
                                exc_info=True)
                finally:
                    self._pods.pop(name, None)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def _set_ready(self, dep: Dict, ready: bool) -> None:
        from tpu_dra_torch.k8s import DEPLOYMENTS

        want = 1 if ready else 0
        if (dep.get("status") or {}).get("readyReplicas", 0) == want:
            return
        dep = dict(dep)
        dep["status"] = {**(dep.get("status") or {}), "readyReplicas": want}
        try:
            self._cluster.update(DEPLOYMENTS, dep, self._namespace)
        except Exception:  # noqa: BLE001 — lost a resourceVersion race;
            pass           # the next tick retries


def _control_socket(pipe_dir: str) -> str:
    return os.path.join(pipe_dir, "control")


def _standin_daemon() -> int:
    """`-f`: serve the control socket until "quit"."""
    pipe_dir = os.environ["CUDA_MPS_PIPE_DIRECTORY"]
    log_dir = os.environ.get("CUDA_MPS_LOG_DIRECTORY", pipe_dir)
    os.makedirs(pipe_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "control.log"), "w") as f:
        for key in sorted(os.environ):
            if key.startswith("CUDA_MPS_") or key == "CUDA_VISIBLE_DEVICES":
                f.write(f"{key}={os.environ[key]}\n")
    # A relative bind keeps the socket path within sun_path's 108 bytes
    # whatever the directory's length.
    os.chdir(pipe_dir)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if os.path.exists("control"):
        os.unlink("control")
    srv.bind("control")
    srv.listen(8)
    while True:
        conn, _ = srv.accept()
        with conn:
            line = conn.makefile().readline().strip()
            conn.sendall(b"\n")
            if line == "quit":
                srv.close()
                os.unlink("control")
                return 0


def _standin_client() -> int:
    """No arguments: each stdin line to the daemon, its reply to stdout."""
    pipe_dir = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "")
    for line in sys.stdin:
        if not line.strip():
            continue
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.chdir(pipe_dir)
            s.connect("control")
            s.sendall(line.strip().encode() + b"\n")
            sys.stdout.write(s.makefile().readline())
        except OSError as e:
            print(f"Cannot find MPS control daemon process: {e}",
                  file=sys.stderr)
            return 1
        finally:
            s.close()
    return 0


def mps_control_standin(argv: List[str]) -> int:
    return _standin_daemon() if argv == ["-f"] else _standin_client()


# ---------------------------------------------------------------------------
# PCI sysfs tree for passthrough
# ---------------------------------------------------------------------------

def make_fake_pci_tree(root: str, gpus, host_driver: str = "nvidia",
                       groups: Optional[Dict[int, int]] = None) -> str:
    """The PCI and IOMMU sysfs of `gpus` under `root`: a device directory
    per GPU (sysfs address of its bus id) with driver_override, its
    driver link (to `host_driver`) and iommu_group link; bind and unbind
    files for `host_driver` and vfio-pci; the vfio_pci module; and
    /dev/nvidia<minor>, /dev/vfio/vfio and /dev/vfio/<group>. Each GPU
    is an IOMMU group of its own, numbered by its index, unless `groups`
    maps its index to another GPU's group."""
    from tpu_dra_torch.gpuplugin.passthrough import VFIO_DRIVER, sysfs_address

    groups = groups or {}
    drivers = os.path.join(root, "sys", "bus", "pci", "drivers")
    for drv in (host_driver, VFIO_DRIVER):
        os.makedirs(os.path.join(drivers, drv), exist_ok=True)
        for f in ("bind", "unbind"):
            open(os.path.join(drivers, drv, f), "w").close()
    os.makedirs(os.path.join(root, "sys", "module", "vfio_pci"),
                exist_ok=True)
    os.makedirs(os.path.join(root, "dev", "vfio"), exist_ok=True)
    open(os.path.join(root, "dev", "vfio", "vfio"), "w").close()
    os.makedirs(os.path.join(root, "proc"), exist_ok=True)
    devices = os.path.join(root, "sys", "bus", "pci", "devices")
    iommu = os.path.join(root, "sys", "kernel", "iommu_groups")
    for gpu in gpus:
        open(os.path.join(root, "dev", f"nvidia{gpu.minor}"), "w").close()
        addr = sysfs_address(gpu.pci_bus_id)
        ddir = os.path.join(devices, addr)
        os.makedirs(ddir, exist_ok=True)
        open(os.path.join(ddir, "driver_override"), "w").close()
        os.symlink(os.path.join("..", "..", "drivers", host_driver),
                   os.path.join(ddir, "driver"))
        group = str(groups.get(gpu.index, gpu.index))
        gdir = os.path.join(iommu, group, "devices")
        os.makedirs(gdir, exist_ok=True)
        os.symlink(ddir, os.path.join(gdir, addr))
        os.symlink(os.path.join(iommu, group),
                   os.path.join(ddir, "iommu_group"))
        open(os.path.join(root, "dev", "vfio", group), "a").close()
    return root


def kernel_pci_sysfs(root: str, host_driver: str = "nvidia",
                     bind_takes: bool = True):
    """A ``PciSysfs`` over `root` whose writes to a driver's bind and
    unbind files take effect as the kernel applies them, when they are
    written: unbind drops the device's driver link if that driver holds
    it; bind links an unbound device whose driver_override names the
    driver (without an override only `host_driver` matches). With
    `bind_takes` False no bind takes (a driver that refuses the device).
    Every write is recorded in `writes` as (path under root, text)."""
    from tpu_dra_torch.gpuplugin.passthrough import PciSysfs

    class _Kernel(PciSysfs):
        def __init__(self):
            super().__init__(root)
            self.writes: List[tuple] = []

        def _write(self, path: str, text: str) -> None:
            super()._write(path, text)
            rel = os.path.relpath(os.path.realpath(path),
                                  os.path.realpath(self.root))
            self.writes.append((rel, text))
            parts = rel.split(os.sep)
            if parts[:4] == ["sys", "bus", "pci", "drivers"] \
                    and parts[5:] in (["bind"], ["unbind"]):
                self._apply(parts[4], parts[5], text.strip())

        def _apply(self, drv: str, op: str, addr: str) -> None:
            ddir = self._p("sys", "bus", "pci", "devices", addr)
            link = os.path.join(ddir, "driver")
            if op == "unbind":
                if self.current_driver(addr) == drv:
                    os.unlink(link)
                return
            if not bind_takes or os.path.islink(link):
                return
            with open(os.path.join(ddir, "driver_override")) as f:
                override = f.read().strip()
            if override and override != drv:
                return
            if not override and drv != host_driver:
                return
            os.symlink(os.path.join("..", "..", "drivers", drv), link)

    return _Kernel()


if __name__ == "__main__":
    sys.exit(mps_control_standin(sys.argv[1:]))


# ---------------------------------------------------------------------------
# ComputeDomain harness
# ---------------------------------------------------------------------------

CD_CDI_VENDOR = "k8s.compute-domain.gpu.dev"
CD_DRIVER_NAMESPACE = "gpu-dra-driver"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reserve_port() -> socket.socket:
    """A socket bound with SO_REUSEADDR to a free port, not listening:
    while it is open the kernel gives that port to no other bind and no
    outgoing connection, and a server that binds it with SO_REUSEADDR
    (a torch TCPStore does) still can."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", 0))
    return s


def _node_main(fn, args, conn) -> None:
    import pickle
    import traceback

    os.setsid()   # run_nodes can then stop the node with its ranks
    try:
        out = ("ok", fn(*args))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out = ("err", traceback.format_exc())
    conn.send_bytes(pickle.dumps(out))


def run_nodes(fn, node_args: Sequence[tuple],
              timeout_s: float = 600.0) -> List:
    """fn(*args) for every args of `node_args` at once, each in a spawned
    process of its own (as each node of a domain runs its own launcher;
    fn and its arguments pickle by reference or value). Returns the
    results in order. A node that raises or does not answer within
    `timeout_s` ends the others (each node's process group, its ranks
    with it), and this raises with its traceback."""
    import multiprocessing
    import multiprocessing.connection
    import pickle
    import signal

    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    ok = False
    try:
        for args in node_args:
            parent, child = ctx.Pipe(duplex=False)
            # Not daemonic: a node's launcher spawns its ranks.
            proc = ctx.Process(target=_node_main, args=(fn, args, child))
            proc.start()
            child.close()
            procs.append(proc)
            conns.append(parent)
        out: Dict[int, object] = {}
        pending = dict(enumerate(conns))
        while pending:
            ready = multiprocessing.connection.wait(list(pending.values()),
                                                    timeout_s)
            if not ready:
                raise TimeoutError(f"nodes {sorted(pending)} did not "
                                   f"answer within {timeout_s} s")
            for i, conn in list(pending.items()):
                if conn not in ready:
                    continue
                try:
                    status, value = pickle.loads(conn.recv_bytes())
                except EOFError:
                    status, value = "err", "the node's process ended"
                if status == "err":
                    raise RuntimeError(f"node {i} failed:\n{value}")
                out[i] = value
                del pending[i]
        ok = True
        return [out[i] for i in range(len(conns))]
    finally:
        for proc in procs:
            proc.join(timeout=30 if ok else 0)
            if proc.is_alive():
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:   # not yet its own group
                    proc.kill()
                proc.join(timeout=10)
        for conn in conns:
            conn.close()


def read_claim_env(cdi, claim_uid: str) -> Dict[str, str]:
    """The workload container's env view of a prepared claim, parsed from
    the WRITTEN CDI spec (the same file kubelet's runtime consumes)."""
    spec = cdi.read_spec(cdi.claim_spec_path(claim_uid))
    return dict(e.split("=", 1)
                for e in spec["devices"][0]["containerEdits"]["env"])


class FakeNode:
    """One 'node': a CD kubelet plugin plus (once labeled) a domain daemon.

    `backend` is the node's GPU discovery: a FakeBackend of an 8-GPU HGX
    node (one node-local NVLink clique) unless given; its clique identity
    (cddaemon.main.discover_clique_id) is the plugin's and the daemon's.
    The daemon is the native one built from this checkout's source, on
    localhost (its pod IP). `coordinator_port` is the plugin's
    --coordinator-port."""

    POD_IP = "127.0.0.1"

    def __init__(self, cluster, name: str, tmp_path, *, backend=None,
                 coordinator_port: Optional[int] = None):
        from tpu_dra_torch.api import types as apitypes
        from tpu_dra_torch.cddaemon import binary
        from tpu_dra_torch.cddaemon.main import discover_clique_id
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.cdplugin.computedomain import (
            COORDINATOR_PORT, ComputeDomainManager,
        )
        from tpu_dra_torch.cdplugin.device_state import DeviceState
        from tpu_dra_torch.cdplugin.driver import CDDriver
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.k8s import NODES
        from tpu_dra_torch.native import gpuinfo

        self.cluster = cluster
        self.name = name
        self.tmp = os.path.join(str(tmp_path), name)
        self.backend = backend if backend is not None else \
            gpuinfo.FakeBackend()
        self.clique_id = discover_clique_id(self.backend)
        self._daemon_bin = binary.build()
        cluster.create(NODES, {"apiVersion": "v1", "kind": "Node",
                               "metadata": {"name": name}})
        plugin_dir = os.path.join(self.tmp, "plugin")
        self.cd_manager = ComputeDomainManager(
            cluster, node_name=name, driver_plugin_dir=plugin_dir,
            coordinator_port=coordinator_port or COORDINATOR_PORT)
        self.cd_manager.start()
        self.cdi = CDIHandler(os.path.join(self.tmp, "cdi"),
                              vendor=CD_CDI_VENDOR)
        self.checkpoints = CheckpointManager(plugin_dir)
        self.state = DeviceState(
            cd_manager=self.cd_manager, cdi=self.cdi,
            checkpoints=self.checkpoints,
            driver_name=apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
            node_name=name, clique_id=self.clique_id)
        self.driver = CDDriver(
            state=self.state, client=cluster,
            driver_name=apitypes.COMPUTE_DOMAIN_DRIVER_NAME, node_name=name,
            clique_id=self.clique_id, plugin_dir=plugin_dir,
            retry_timeout=20.0)
        self.driver.start()
        self.daemon = None

    def wait_labeled(self, cd_uid: str, timeout: float = 20.0) -> bool:
        from tpu_dra_torch.api import types as apitypes
        from tpu_dra_torch.k8s import NODES

        return self.cluster.wait_for(
            lambda: (self.cluster.get(NODES, self.name)["metadata"]
                     .get("labels") or {}).get(
                apitypes.COMPUTE_DOMAIN_LABEL_KEY) == cd_uid,
            timeout=timeout)

    def start_daemon(self, cd) -> None:
        """The DaemonSet-pod analog, started when the node is labeled:
        a DaemonRunner over the real native daemon on a free port."""
        from tpu_dra_torch.cddaemon.main import DaemonRunner
        from tpu_dra_torch.cddaemon.main import flags as daemon_flags

        ns = daemon_flags().parse([
            "--cd-uid", cd["metadata"]["uid"],
            "--cd-name", cd["metadata"]["name"],
            "--cd-namespace", cd["metadata"]["namespace"],
            "--node-name", self.name, "--pod-ip", self.POD_IP,
            "--port", str(free_port()),
            "--work-dir", os.path.join(self.tmp, "daemon"),
            "--hosts-file", os.path.join(self.tmp, "hosts"),
            "--daemon-binary", self._daemon_bin,
        ])
        self.daemon = DaemonRunner(self.cluster, ns, backend=self.backend)
        self.daemon.start()

    def stop_daemon(self) -> None:
        if self.daemon is not None:
            self.daemon.stop()
            self.daemon = None

    def stop(self) -> None:
        self.stop_daemon()
        self.driver.shutdown()
        self.cd_manager.stop()
        self.checkpoints.close()


def channel_claim(cluster, cd: Dict, node: str, namespace: str) -> Dict:
    """A workload claim of the domain's channel-0 on `node`, allocated as
    the scheduler would from the CD's workload ResourceClaimTemplate."""
    from tpu_dra_torch.api import types as apitypes
    from tpu_dra_torch.k8s import RESOURCECLAIMS

    return cluster.create(RESOURCECLAIMS, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": f"w-{node}", "namespace": namespace},
        "spec": {"devices": {"requests": [{"name": "r0"}]}},
        "status": {"allocation": {"devices": {
            "results": [{
                "request": "r0",
                "driver": apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
                "pool": node, "device": "channel-0"}],
            "config": [{"requests": ["r0"], "opaque": {
                "driver": apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
                "parameters": apitypes.ComputeDomainChannelConfig(
                    domain_id=cd["metadata"]["uid"]).to_dict()}}]}}},
    })


class DomainSim:
    """The compute-domain stack over one FakeCluster: the controller and
    one FakeNode per entry of `nodes` ({name: backend or None}). Plays
    the scheduler (channel claims), kubelet (the CD plugin's prepare and
    unprepare) and the DaemonSet (a daemon on each node once labeled).
    Use as a context manager; `root` (a temporary dir by default) holds
    every node's sockets and state. The CD plugins' coordinator port, the
    workload env's MASTER_PORT, is a free one that the sim holds
    (reserve_port) until it closes, so that nothing else takes it before
    the domain's TCPStore binds it."""

    # How long prepare_channels waits for a node's label and its claims.
    JOIN_TIMEOUT_S = 60.0

    def __init__(self, nodes: Dict[str, object], *,
                 namespace: str = "cdtest", root: Optional[str] = None):
        import tempfile

        from tpu_dra_torch.cdcontroller import Controller
        from tpu_dra_torch.k8s import FakeCluster

        self.namespace = namespace
        self._port_hold = reserve_port()
        self.coordinator_port = self._port_hold.getsockname()[1]
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="gpu-dra-cd-")
        self.cluster = FakeCluster()
        self.controller = Controller(self.cluster,
                                     namespace=CD_DRIVER_NAMESPACE,
                                     image="harness", gc_interval=3600.0)
        self.controller.start()
        self.nodes: List[FakeNode] = []
        try:
            for name, backend in nodes.items():
                self.nodes.append(FakeNode(
                    self.cluster, name, self.root, backend=backend,
                    coordinator_port=self.coordinator_port))
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> "DomainSim":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def create_cd(self, name: str = "harness-cd") -> Dict:
        """A ComputeDomain of every node of the sim (numNodes)."""
        from tpu_dra_torch.api import types as apitypes
        from tpu_dra_torch.k8s import COMPUTEDOMAINS

        return self.cluster.create(COMPUTEDOMAINS, {
            "apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
            "metadata": {"name": name, "namespace": self.namespace},
            "spec": {"numNodes": len(self.nodes),
                     "channel": {"resourceClaimTemplate": {
                         "name": f"{name}-rct"}}},
        })

    def prepare_channels(self, cd: Dict) -> Dict:
        """One channel claim per node, prepared on every node at once
        while a daemon starts on each node as it is labeled. Returns
        {"ok", "error", "elapsed_s" (CD creation -> every claim prepared,
        from the CD's own creation), "envs" {node: claim env},
        "claims" {node: claim}}."""
        import threading
        import time

        from tpu_dra_torch.kubeletplugin.server import Claim

        t0 = time.perf_counter()
        results: Dict[str, object] = {}
        envs: Dict[str, Dict[str, str]] = {}
        claims = {n.name: channel_claim(self.cluster, cd, n.name,
                                        self.namespace) for n in self.nodes}

        def kubelet(node):
            claim = claims[node.name]
            c = Claim(uid=claim["metadata"]["uid"],
                      name=claim["metadata"]["name"],
                      namespace=self.namespace)
            results[node.name] = node.driver.prepare_claims([c])[c.uid]
            if not results[node.name].error:
                envs[node.name] = read_claim_env(node.cdi, c.uid)

        threads = [threading.Thread(target=kubelet, args=(n,),
                                    name=f"kubelet-{n.name}")
                   for n in self.nodes]
        for t in threads:
            t.start()
        failure = None
        for node in self.nodes:
            if not node.wait_labeled(cd["metadata"]["uid"],
                                     timeout=self.JOIN_TIMEOUT_S):
                failure = f"{node.name} never labeled"
                break
            node.start_daemon(cd)
        for t in threads:
            t.join(timeout=self.JOIN_TIMEOUT_S)
        elapsed = time.perf_counter() - t0
        if failure is None and any(t.is_alive() for t in threads):
            failure = "kubelet prepare threads timed out"
        if failure is None:
            errors = [f"{n}: {r.error}" for n, r in results.items()
                      if r.error]
            if errors or len(envs) != len(self.nodes):
                failure = "; ".join(errors) or "prepare incomplete"
        if failure:
            # Drain the prepare retry loops before the caller tears the
            # state dirs out from under them.
            for t in threads:
                t.join()
        return {"ok": failure is None, "error": failure,
                "elapsed_s": elapsed, "envs": envs, "claims": claims}

    def teardown(self, cd: Dict, claims: Dict[str, Dict]) -> Dict:
        """Unprepare each node's claim, stop the daemons, delete the CD
        and wait until it is gone. Returns what is left of it: the nodes
        still labeled for it, the stamped DaemonSets and the templates
        carrying its label, and the unprepare errors."""
        from tpu_dra_torch.api import types as apitypes
        from tpu_dra_torch.k8s import (
            COMPUTEDOMAINS, DAEMONSETS, NODES, RESOURCECLAIMTEMPLATES,
        )
        from tpu_dra_torch.k8s.client import NotFoundError
        from tpu_dra_torch.kubeletplugin.server import Claim

        errors = {}
        for node in self.nodes:
            claim = claims.get(node.name)
            if claim is None:
                continue
            c = Claim(uid=claim["metadata"]["uid"],
                      name=claim["metadata"]["name"],
                      namespace=self.namespace)
            err = node.driver.unprepare_claims([c])[c.uid]
            if err:
                errors[node.name] = err
        for node in self.nodes:
            node.stop_daemon()
        meta = cd["metadata"]
        self.cluster.delete(COMPUTEDOMAINS, meta["name"], meta["namespace"])

        def gone():
            try:
                self.cluster.get(COMPUTEDOMAINS, meta["name"],
                                 meta["namespace"])
                return False
            except NotFoundError:
                return True

        deleted = self.cluster.wait_for(gone, timeout=20.0)
        key = apitypes.COMPUTE_DOMAIN_LABEL_KEY
        selector = f"{key}={meta['uid']}"
        return {
            "cd_deleted": deleted,
            "labeled_nodes": sorted(
                n["metadata"]["name"] for n in self.cluster.list(NODES)
                if (n["metadata"].get("labels") or {}).get(key)
                == meta["uid"]),
            "daemonsets": [d["metadata"]["name"] for d in self.cluster.list(
                DAEMONSETS, label_selector=selector)],
            "templates": [t["metadata"]["name"] for t in self.cluster.list(
                RESOURCECLAIMTEMPLATES, label_selector=selector)],
            "unprepare_errors": errors,
        }

    def close(self) -> None:
        import shutil

        for node in self.nodes:
            try:
                node.stop()
            except Exception:  # noqa: BLE001 — stop every node regardless
                log.warning("stopping %s", node.name, exc_info=True)
        self.nodes = []
        self.controller.stop()
        self._port_hold.close()
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)


def provision_multi_node_cd(n_nodes: int = 2, namespace: str = "cdtest",
                            node_names: Optional[Sequence[str]] = None
                            ) -> Dict:
    """Provision an N-node ComputeDomain through the full CD stack —
    controller + CD kubelet plugins + real native domain daemons
    converging over the fake API server, simulated nodes of 8 fake GPUs
    each — and prepare one workload channel claim per node; then tear it
    down.

    Returns {"ok", "error", "elapsed_s", "envs", "teardown"}: elapsed_s
    is CD creation -> all claims prepared, envs maps node name -> the
    prepared claim's CDI env (the workload container's view:
    GPU_WORKER_ID, GPU_WORKER_HOSTNAMES, MASTER_ADDR, MASTER_PORT,
    NODE_RANK, NNODES, ...), teardown is DomainSim.teardown's report
    (when the domain converged)."""
    if node_names is None:
        node_names = tuple(f"node-{i:02d}" for i in range(n_nodes))
    with DomainSim(dict.fromkeys(node_names), namespace=namespace) as sim:
        cd = sim.create_cd()
        res = sim.prepare_channels(cd)
        if res["ok"]:
            res["teardown"] = sim.teardown(cd, res["claims"])
        res.pop("claims")
        return res


def provision_two_node_cd(namespace: str = "cdtest") -> Dict:
    """The 2-node domain of bench.bench_cd_convergence
    (provision_multi_node_cd)."""
    return provision_multi_node_cd(namespace=namespace,
                                   node_names=("node-a", "node-b"))


# ---------------------------------------------------------------------------
# Scheduler inventory (shared by the churn, topology and failover benches
# and the scheduler's HA tests)
# ---------------------------------------------------------------------------

DEFAULT_SCHED_SELECTOR = ('device.driver == "gpu.dev" && '
                          'device.attributes["gpu.dev"].type == "gpu"')


def seed_sched_inventory(client, *, nodes: int, gpus_per_node: int,
                         node_fmt: str = "n{i}",
                         selector_exprs=None,
                         namespace: str = "default",
                         nodes_per_clique: int = 1,
                         claim_counts=()) -> List[str]:
    """Seed the scheduler's fixture in one place (counterpart of the
    reference's seed_sched_inventory): DeviceClass ``gpu.dev`` (CEL
    selectors), ResourceClaimTemplate ``tmpl``, and `nodes` Nodes each
    publishing a ResourceSlice of `gpus_per_node` whole H100s with the
    attribute set the kubelet plugin publishes from NVML (type, uuid,
    productName, index, pciBusID, architecture, clique, workerIndex,
    coordX/Y/Z, fabricTopology), so the scheduler's placement scoring
    reads these slices as it reads a real node's. Returns the node
    names. `nodes_per_clique` groups consecutive nodes into one NVLink
    clique (a shared clique id, workerIndex 0..n-1; the reference's
    hosts_per_slice); `claim_counts` also creates a ``tmpl<n>``
    template requesting n GPUs for each n. `gpus_per_node` stands for the
    reference's chips_per_node."""
    import dataclasses

    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.gpuplugin.deviceinfo import (
        DEVICE_TYPE_GPU, AllocatableDevice,
    )
    from tpu_dra_torch.k8s.resources import (
        DEVICECLASSES, NODES, RESOURCECLAIMTEMPLATES, RESOURCESLICES,
    )
    from tpu_dra_torch.kubeletplugin.server import build_resource_slice
    from tpu_dra_torch.native.gpuinfo import default_fake_gpus

    exprs = (list(selector_exprs) if selector_exprs
             else [DEFAULT_SCHED_SELECTOR])
    client.create(DEVICECLASSES, {
        "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
        "metadata": {"name": GPU_DRIVER_NAME},
        "spec": {"selectors": [{"cel": {"expression": e}} for e in exprs]}})
    for count in (None,) + tuple(claim_counts):
        req = {"name": "gpu", "exactly": {"deviceClassName": GPU_DRIVER_NAME}}
        if count is not None:
            req["exactly"]["count"] = count
        client.create(RESOURCECLAIMTEMPLATES, {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "tmpl" if count is None else f"tmpl{count}",
                         "namespace": namespace},
            "spec": {"spec": {"devices": {"requests": [req]}}},
        }, namespace=namespace)
    names = []
    for i in range(nodes):
        name = node_fmt.format(i=i)
        names.append(name)
        gpus = default_fake_gpus(gpus_per_node,
                                 clique_id=f"nvl-{i // nodes_per_clique}",
                                 worker_index=i % nodes_per_clique)
        # One UUID per GPU of the fleet (the fake's are per node).
        gpus = [dataclasses.replace(
            g, uuid=f"GPU-{i:04x}{g.index:04x}-5eed-4000-8000-"
                    f"{g.index:012x}") for g in gpus]
        client.create(NODES, {"apiVersion": "v1", "kind": "Node",
                              "metadata": {"name": name, "labels": {}}})
        client.create(RESOURCESLICES, build_resource_slice(
            GPU_DRIVER_NAME, name,
            [AllocatableDevice(type=DEVICE_TYPE_GPU, gpu=g).to_resource_api()
             for g in gpus]))
    return names


def make_sched_pod(client, name: str, namespace: str = "default",
                   template: str = "tmpl"):
    """A pod claiming GPUs through `template` (the fixture's pod shape;
    multi-GPU templates are the ``tmpl<n>`` that seed_sched_inventory's
    claim_counts creates)."""
    from tpu_dra_torch.k8s.resources import PODS

    return client.create(PODS, {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"containers": [{"name": "c", "image": "x"}],
                 "resourceClaims": [
                     {"name": "t", "resourceClaimTemplateName": template}]},
    }, namespace=namespace)
