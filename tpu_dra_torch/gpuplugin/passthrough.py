"""VFIO passthrough: rebind a GPU's PCI function from the ``nvidia``
driver to ``vfio-pci`` so that a VM workload can claim the whole device
(counterpart of tpu_dra/tpuplugin/passthrough.py).

The kernel's sysfs protocol, as NVIDIA's bind_to_driver.sh and
unbind_from_driver.sh run it: write the target driver into the device's
``driver_override``, unbind through the bound driver's ``unbind`` file,
bind through the target driver's ``bind`` file, then clear the override
(also when the bind fails, so the device can rebind normally later).
Every function of the GPU's IOMMU group leaves the host driver as a unit,
or the kernel refuses the vfio fd; DeviceState makes that safe by
refusing a passthrough claim whose group another claim holds.

Before a function is unbound, no process may hold its ``/dev/nvidia<minor>``
open: ``PciSysfs.open_fds_for`` scans ``/proc/*/fd`` (no ``fuser``
needed). Every path lives under an injectable root, so the whole flow
runs on a fake tree (``tpu_dra_torch.testing.make_fake_pci_tree``), and
the waits take an injectable clock and sleep.

The PCI address is the GPU's bus id from ``Gpu.pci_bus_id``, which NVML
gives with an 8-digit domain ("00000000:18:00.0") and sysfs names with a
4-digit one ("0000:18:00.0"); on a host whose NVML withholds PCI info it
comes from the CUDA driver API.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from tpu_dra_torch.native.gpuinfo import Gpu

log = logging.getLogger(__name__)

VFIO_DRIVER = "vfio-pci"
# The driver NVIDIA GPUs are normally bound to.
NVIDIA_DRIVER = "nvidia"


class PassthroughError(Exception):
    pass


def sysfs_address(pci_bus_id: str) -> str:
    """A PCI bus id as sysfs names the device: "00000000:18:00.0" ->
    "0000:18:00.0" (4-digit domain, lower case)."""
    bus = pci_bus_id.strip().lower()
    domain, sep, rest = bus.partition(":")
    if not sep:
        return bus
    return f"{int(domain, 16):04x}:{rest}"


class PciSysfs:
    """Raw sysfs, /dev and /proc operations under an injectable root. The
    paths are the kernel ABI's; every write goes through `_write`."""

    def __init__(self, root: str = "/"):
        self.root = root.rstrip("/")

    def _p(self, *parts: str) -> str:
        return os.path.join(self.root + "/", *parts)

    def _write(self, path: str, text: str) -> None:
        with open(path, "w") as f:
            f.write(text)

    # -- module / IOMMU prechecks ------------------------------------------

    def module_loaded(self, module: str) -> bool:
        return os.path.isdir(self._p("sys", "module", module))

    def iommu_enabled(self) -> bool:
        try:
            return bool(os.listdir(self._p("sys", "kernel", "iommu_groups")))
        except FileNotFoundError:
            return False

    # -- device state -------------------------------------------------------

    def current_driver(self, pci_address: str) -> Optional[str]:
        link = self._p("sys", "bus", "pci", "devices", pci_address, "driver")
        try:
            return os.path.basename(os.readlink(link))
        except OSError:
            return None

    def iommu_group(self, pci_address: str) -> Optional[str]:
        link = self._p("sys", "bus", "pci", "devices", pci_address,
                       "iommu_group")
        try:
            return os.path.basename(os.readlink(link))
        except OSError:
            return None

    def group_devices(self, group: str) -> List[str]:
        try:
            return sorted(os.listdir(self._p("sys", "kernel", "iommu_groups",
                                             group, "devices")))
        except FileNotFoundError:
            return []

    # -- rebind primitives (bind_to_driver.sh semantics) --------------------

    def write_driver_override(self, pci_address: str, driver: str) -> None:
        path = self._p("sys", "bus", "pci", "devices", pci_address,
                       "driver_override")
        if not os.path.exists(path):
            raise PassthroughError(f"{path} does not exist")
        self._write(path, driver + "\n" if driver else "\n")

    def unbind(self, pci_address: str) -> None:
        """Write the address to the bound driver's unbind file; a no-op
        when the device is bound to nothing."""
        if self.current_driver(pci_address) is None:
            return
        self._write(self._p("sys", "bus", "pci", "devices", pci_address,
                            "driver", "unbind"), pci_address)

    def bind(self, pci_address: str, driver: str) -> None:
        path = self._p("sys", "bus", "pci", "drivers", driver, "bind")
        if not os.path.exists(path):
            raise PassthroughError(
                f"driver {driver!r} has no bind file at {path}")
        self._write(path, pci_address)

    # -- busy check ---------------------------------------------------------

    def open_fds_for(self, dev_path: str) -> List[int]:
        """Pids holding an open fd on `dev_path`, from a /proc scan."""
        target = self._p(dev_path.lstrip("/"))
        proc = self._p("proc")
        try:
            entries = os.listdir(proc)
        except FileNotFoundError:
            return []
        pids: List[int] = []
        for pid in entries:
            if not pid.isdigit():
                continue
            fd_dir = os.path.join(proc, pid, "fd")
            try:
                fds = os.listdir(fd_dir)
            except OSError:
                continue
            for fd in fds:
                try:
                    if os.readlink(os.path.join(fd_dir, fd)) in (dev_path,
                                                                 target):
                        pids.append(int(pid))
                        break
                except OSError:
                    continue
        return sorted(pids)


class PassthroughManager:
    """Configure/unconfigure GPUs for VFIO passthrough. The busy wait
    runs under DeviceState's locks, capped at `free_timeout` seconds so a
    stuck passthrough prepare cannot hold them past kubelet's retry
    window."""

    def __init__(self, sysfs: Optional[PciSysfs] = None, *,
                 host_driver: str = NVIDIA_DRIVER,
                 free_timeout: float = 30.0, free_interval: float = 1.0,
                 bind_timeout: float = 5.0, bind_interval: float = 0.02,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self._fs = sysfs or PciSysfs()
        self._host_driver = host_driver
        self._free_timeout = free_timeout
        self._free_interval = free_interval
        self._bind_timeout = bind_timeout
        self._bind_interval = bind_interval
        self._clock = clock
        self._sleep = sleep
        self._locks: Dict[str, threading.Lock] = {}
        self._locks_mu = threading.Lock()

    def _lock_for(self, key: str) -> threading.Lock:
        with self._locks_mu:
            return self._locks.setdefault(key, threading.Lock())

    def prechecks(self) -> None:
        if not self._fs.module_loaded("vfio_pci"):
            raise PassthroughError("vfio_pci module is not loaded")
        if not self._fs.iommu_enabled():
            raise PassthroughError("IOMMU is not enabled in the kernel")

    # -- group topology (DeviceState's exclusivity guard) -------------------

    def group_of(self, gpu: Gpu) -> Optional[str]:
        if not gpu.pci_bus_id:
            return None
        return self._fs.iommu_group(sysfs_address(gpu.pci_bus_id))

    def group_devices(self, group: str) -> List[str]:
        return self._fs.group_devices(group)

    # -- configure ----------------------------------------------------------

    def configure(self, gpu: Gpu,
                  sibling_dev_paths: Optional[Dict[str, str]] = None) -> str:
        """Bind the GPU and its IOMMU-group siblings to vfio-pci; returns
        the group whose /dev/vfio/<group> node the claim gets. Idempotent.
        `sibling_dev_paths` maps the sysfs addresses of other GPUs in the
        group to their device nodes, so the busy wait covers them too.
        The caller has made sure no other claim holds the group."""
        if not gpu.pci_bus_id:
            raise PassthroughError(
                f"GPU {gpu.index} has no PCI bus id; cannot pass it through")
        addr = sysfs_address(gpu.pci_bus_id)
        with self._lock_for(addr):
            self.prechecks()
            group = self._fs.iommu_group(addr)
            if group is None:
                raise PassthroughError(
                    f"GPU {gpu.index} ({addr}) has no IOMMU group")
            sib = sibling_dev_paths or {}
            for a in self._fs.group_devices(group) or [addr]:
                busy = gpu.dev_path if a == addr else sib.get(a)
                self._rebind(a, VFIO_DRIVER, busy_dev=busy)
            return group

    def unconfigure(self, gpu: Gpu) -> None:
        """Return the GPU's group to the host driver. Idempotent."""
        if not gpu.pci_bus_id:
            return
        addr = sysfs_address(gpu.pci_bus_id)
        with self._lock_for(addr):
            group = self._fs.iommu_group(addr)
            for a in self._fs.group_devices(group) if group else [addr]:
                self._rebind(a, self._host_driver, busy_dev=None)

    def cdi_device_nodes(self, group: str) -> List[Dict]:
        """The claim's VFIO device nodes for a configured group."""
        return [{"path": "/dev/vfio/vfio"}, {"path": f"/dev/vfio/{group}"}]

    # -- internals ----------------------------------------------------------

    def _rebind(self, pci_address: str, target: str,
                busy_dev: Optional[str]) -> None:
        current = self._fs.current_driver(pci_address)
        if current == target:
            return
        # Only rebinds between the host driver and vfio-pci; a function
        # bound to anything else is the operator's.
        if current is not None and current not in (self._host_driver,
                                                   VFIO_DRIVER):
            raise PassthroughError(
                f"{pci_address} is bound to {current!r}, expected "
                f"{self._host_driver!r} or {VFIO_DRIVER!r}")
        if busy_dev is not None:
            self._wait_device_free(pci_address, busy_dev)
        self._fs.write_driver_override(pci_address, target)
        try:
            self._fs.unbind(pci_address)
            self._fs.bind(pci_address, target)
            self._wait_bound(pci_address, target)
        except Exception:
            try:
                self._fs.write_driver_override(pci_address, "")
            except Exception:  # noqa: BLE001 — the bind error is the one
                log.warning("override rollback failed for %s", pci_address)
            raise
        # Clear the override so later hotplug events bind normally.
        self._fs.write_driver_override(pci_address, "")
        log.info("rebound %s -> %s", pci_address, target)

    def _wait_device_free(self, pci_address: str, dev_path: str) -> None:
        deadline = self._clock() + self._free_timeout
        while True:
            pids = self._fs.open_fds_for(dev_path)
            if not pids:
                return
            if self._clock() >= deadline:
                raise PassthroughError(
                    f"timed out waiting for {dev_path} ({pci_address}) to "
                    f"be free; held by pids {pids}")
            log.info("%s busy (pids %s); waiting", dev_path, pids)
            self._sleep(self._free_interval)

    def _wait_bound(self, pci_address: str, driver: str) -> None:
        deadline = self._clock() + self._bind_timeout
        while self._fs.current_driver(pci_address) != driver:
            if self._clock() >= deadline:
                raise PassthroughError(
                    f"{pci_address} did not bind to {driver} within "
                    f"{self._bind_timeout}s (bound: "
                    f"{self._fs.current_driver(pci_address)!r})")
            self._sleep(self._bind_interval)
