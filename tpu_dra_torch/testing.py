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
