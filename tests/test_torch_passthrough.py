"""Port parity: VFIO passthrough (tpu_dra_torch.gpuplugin.passthrough,
and DeviceState's passthrough claims) against tpu_dra.tpuplugin.
passthrough, on the CPU.

The reference's test_passthrough.py cases run here on the port's fake
tree (tpu_dra_torch.testing.make_fake_pci_tree): prechecks, the rebind
and its idempotence, the rollback of the override on a failed bind, the
busy check, the IOMMU group's siblings rebound as a unit, and the group
exclusivity in both directions through DeviceState. Then one sequence
is driven through the reference's PassthroughManager and the port's on
parallel trees, and the sysfs writes are held equal after NAME_MAP.

The reference's TestRebind is flaky: its FakeKernelPci thread consumes a
driver's bind file on its own clock. When the thread reads the vfio-pci
bind request in the same tick in which the device's unbind request
(written a moment before it) is still pending — it processes unbinds
before binds, and the unbind landed after it looked — the device is
still bound, the bind request is truncated away, and the rebind waits
out its 5 s bind timeout. The port's fake kernel applies each write when
it is made (tpu_dra_torch.testing.kernel_pci_sysfs), and every wait runs
on a FakeClock whose sleep advances it: no thread, no sleep, no
wall-clock wait.
"""

import dataclasses
import os
import shutil

import pytest
import torch

from tpu_dra.native.tpuinfo import make_fake_sysfs
from tpu_dra.testing import FakeKernelPci
from tpu_dra.tpuplugin.passthrough import PassthroughManager as RefManager
from tpu_dra.tpuplugin.passthrough import PciSysfs as RefSysfs
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.gpuplugin.passthrough import (
    NVIDIA_DRIVER, VFIO_DRIVER, PassthroughError, PassthroughManager,
    sysfs_address,
)
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.testing import kernel_pci_sysfs, make_fake_pci_tree

from test_torch_cdi import reference_chips
from test_torch_mig import _Crash, claim, crash_at_terminal_commit

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

# Reference -> port, applied to the reference's recorded sysfs writes.
NAME_MAP = (("tpu-accel", NVIDIA_DRIVER),)
PASSTHROUGH = {"apiVersion": port_types.API_VERSION,
               "kind": "PassthroughConfig"}


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


class FakeClock:
    """monotonic() and sleep() for the manager's waits: a sleep advances
    the clock and runs `on_sleep`."""

    def __init__(self, on_sleep=None):
        self.t = 0.0
        self.sleeps = 0
        self.on_sleep = on_sleep

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds
        self.sleeps += 1
        if self.on_sleep is not None:
            self.on_sleep(self)


def manager(fs, clock=None, **kw):
    clock = clock or FakeClock()
    return PassthroughManager(fs, clock=clock, sleep=clock.sleep, **kw)


@pytest.fixture
def tree(tmp_path):
    gpus = gpuinfo.default_fake_gpus(2)
    root = make_fake_pci_tree(str(tmp_path / "root"), gpus)
    return root, gpus, kernel_pci_sysfs(root)


def addr(gpu):
    return sysfs_address(gpu.pci_bus_id)


def override(root, gpu):
    with open(os.path.join(root, "sys", "bus", "pci", "devices", addr(gpu),
                           "driver_override")) as f:
        return f.read().strip()


def test_sysfs_address():
    assert sysfs_address("00000000:4C:00.0") == "0000:4c:00.0"
    assert sysfs_address("0000:18:00.0") == "0000:18:00.0"


class TestPciSysfs:
    def test_prechecks_pass_on_fake_tree(self, tree):
        manager(tree[2]).prechecks()

    def test_precheck_fails_without_vfio_module(self, tree):
        root, _, fs = tree
        shutil.rmtree(os.path.join(root, "sys", "module", "vfio_pci"))
        with pytest.raises(PassthroughError, match="vfio_pci module"):
            manager(fs).prechecks()

    def test_precheck_fails_without_iommu(self, tree):
        root, _, fs = tree
        shutil.rmtree(os.path.join(root, "sys", "kernel", "iommu_groups"))
        with pytest.raises(PassthroughError, match="IOMMU"):
            manager(fs).prechecks()

    def test_current_driver_and_group(self, tree):
        _, gpus, fs = tree
        assert fs.current_driver(addr(gpus[0])) == NVIDIA_DRIVER
        assert fs.iommu_group(addr(gpus[0])) == "0"
        assert fs.group_devices("0") == [addr(gpus[0])]
        assert manager(fs).group_of(gpus[1]) == "1"


class TestRebind:
    def test_configure_rebinds_to_vfio(self, tree):
        root, gpus, fs = tree
        assert manager(fs).configure(gpus[0]) == "0"
        assert fs.current_driver(addr(gpus[0])) == VFIO_DRIVER
        assert override(root, gpus[0]) == ""
        assert fs.current_driver(addr(gpus[1])) == NVIDIA_DRIVER

    def test_configure_idempotent(self, tree):
        _, gpus, fs = tree
        mgr = manager(fs)
        assert mgr.configure(gpus[0]) == mgr.configure(gpus[0]) == "0"
        assert len(fs.writes) == 4   # override, unbind, bind, override

    def test_unconfigure_restores_nvidia_driver(self, tree):
        _, gpus, fs = tree
        mgr = manager(fs)
        mgr.configure(gpus[0])
        mgr.unconfigure(gpus[0])
        assert fs.current_driver(addr(gpus[0])) == NVIDIA_DRIVER
        n = len(fs.writes)
        mgr.unconfigure(gpus[0])   # idempotent
        assert len(fs.writes) == n

    def test_configure_refuses_foreign_driver(self, tree):
        root, gpus, fs = tree
        link = os.path.join(root, "sys", "bus", "pci", "devices",
                            addr(gpus[0]), "driver")
        os.unlink(link)
        os.makedirs(os.path.join(root, "sys", "bus", "pci", "drivers",
                                 "nouveau"))
        os.symlink(os.path.join("..", "..", "drivers", "nouveau"), link)
        with pytest.raises(PassthroughError, match="bound to 'nouveau'"):
            manager(fs).configure(gpus[0])
        assert fs.writes == []

    def test_busy_device_waits_then_times_out(self, tree):
        root, gpus, fs = tree
        fd_dir = os.path.join(root, "proc", "4242", "fd")
        os.makedirs(fd_dir)
        os.symlink(os.path.join(root, "dev", f"nvidia{gpus[0].minor}"),
                   os.path.join(fd_dir, "7"))
        clock = FakeClock()
        with pytest.raises(PassthroughError,
                           match=r"held by pids \[4242\]"):
            manager(fs, clock, free_timeout=3.0,
                    free_interval=1.0).configure(gpus[0])
        assert clock.sleeps == 3
        assert fs.current_driver(addr(gpus[0])) == NVIDIA_DRIVER
        assert fs.writes == []   # no half-rebind

    def test_busy_device_proceeds_once_freed(self, tree):
        root, gpus, fs = tree
        fd_dir = os.path.join(root, "proc", "4242", "fd")
        os.makedirs(fd_dir)
        fd = os.path.join(fd_dir, "7")
        os.symlink(os.path.join(root, "dev", f"nvidia{gpus[0].minor}"), fd)

        def close_after_two_polls(clock):
            if clock.sleeps == 2:
                os.unlink(fd)
        clock = FakeClock(close_after_two_polls)
        assert manager(fs, clock).configure(gpus[0]) == "0"
        assert clock.sleeps == 2
        assert fs.current_driver(addr(gpus[0])) == VFIO_DRIVER

    def test_bind_failure_rolls_back_override(self, tree):
        root, gpus, _ = tree
        fs = kernel_pci_sysfs(root, bind_takes=False)
        clock = FakeClock()
        with pytest.raises(PassthroughError, match="did not bind"):
            manager(fs, clock, bind_timeout=0.2).configure(gpus[0])
        assert override(root, gpus[0]) == ""
        assert clock.t >= 0.2

    def test_group_siblings_rebound_as_unit(self, tmp_path):
        gpus = gpuinfo.default_fake_gpus(2)
        root = make_fake_pci_tree(str(tmp_path / "root"), gpus,
                                  groups={1: 0})
        fs = kernel_pci_sysfs(root)
        mgr = manager(fs)
        assert mgr.group_devices("0") == sorted(addr(g) for g in gpus)
        assert mgr.configure(gpus[0]) == "0"
        assert {fs.current_driver(addr(g)) for g in gpus} == {VFIO_DRIVER}
        mgr.unconfigure(gpus[0])
        assert {fs.current_driver(addr(g)) for g in gpus} == {NVIDIA_DRIVER}


class Node:
    """A port DeviceState with a PassthroughManager over a fake tree."""

    def __init__(self, tmp, groups=None):
        port_gates.Features.set_from_string("PassthroughSupport=true")
        self.tmp = tmp
        self.gpus = gpuinfo.default_fake_gpus(2)
        self.root = make_fake_pci_tree(str(tmp / "root"), self.gpus,
                                       groups=groups)
        self.fs = kernel_pci_sysfs(self.root)
        self.backend = gpuinfo.FakeBackend(self.gpus)
        self.cdi = CDIHandler(str(tmp / "cdi"), driver_root=self.root)
        self.start()

    def start(self):
        self.ckpt = CheckpointManager(str(self.tmp / "ckpt"))
        self.state = DeviceState(
            backend=self.backend, cdi=self.cdi, checkpoints=self.ckpt,
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a",
            pt_manager=manager(self.fs))

    def driver(self, i):
        return self.fs.current_driver(addr(self.gpus[i]))


@pytest.fixture
def node(tmp_path):
    n = Node(tmp_path)
    yield n
    n.state.close()


@pytest.fixture
def grouped(tmp_path):
    n = Node(tmp_path, groups={1: 0})
    yield n
    n.state.close()


class TestDeviceState:
    def test_claim_gets_only_claim_cdi_device(self, node):
        res = node.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH]))
        assert res.error == ""
        (dev,) = res.devices
        assert dev.cdi_device_ids == [node.cdi.get_claim_device("pt")]

    def test_prepare_rebinds_and_injects_vfio_nodes(self, node):
        node.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH]))
        assert node.driver(0) == VFIO_DRIVER
        assert node.backend.exclusive == {0: True}
        spec = node.cdi.read_spec(node.cdi.claim_spec_path("pt"))
        edits = spec["devices"][0]["containerEdits"]
        assert edits["deviceNodes"] == [{"path": "/dev/vfio/vfio"},
                                        {"path": "/dev/vfio/0"}]
        assert "GPU_PASSTHROUGH=true" in edits["env"]

    def test_unprepare_reverses_rebind(self, node):
        node.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH]))
        assert node.state.unprepare("pt") is None
        assert node.driver(0) == NVIDIA_DRIVER
        assert node.backend.exclusive == {0: False}

    def test_passthrough_conflicts_with_sibling_claim(self, grouped):
        n = grouped
        assert n.state.prepare(claim("plain", ["gpu-1"])).error == ""
        res = n.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH]))
        assert "shares an IOMMU group" in res.error
        assert "claim plain" in res.error
        assert n.driver(1) == n.driver(0) == NVIDIA_DRIVER
        assert n.state.prepared_claim_uids() == ["plain"]
        assert n.cdi.list_claim_uids() == ["plain"]

    def test_normal_claim_conflicts_with_passthrough_group(self, grouped):
        n = grouped
        assert n.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH])
                               ).error == ""
        assert n.driver(1) == VFIO_DRIVER   # the sibling went with it
        res = n.state.prepare(claim("plain", ["gpu-1"]))
        assert "shares an IOMMU group" in res.error
        assert n.state.prepared_claim_uids() == ["pt"]

    def test_crash_after_intent_rolled_back(self, node):
        crash_at_terminal_commit(node.ckpt)
        with pytest.raises(_Crash):
            node.state.prepare(claim("pt", ["gpu-0"], [PASSTHROUGH]))
        assert node.driver(0) == VFIO_DRIVER
        node.start()
        assert node.driver(0) == NVIDIA_DRIVER
        assert node.backend.exclusive[0] is False
        assert node.state.prepared_claim_uids() == []
        assert node.cdi.list_claim_uids() == []


class RefRecordingSysfs(RefSysfs):
    """The reference's PciSysfs with its writes recorded as the port's
    are, and the reference's fake kernel stepped after each bind or
    unbind write: its own bind semantics, with no thread."""

    def __init__(self, root):
        super().__init__(root)
        self.kernel = FakeKernelPci(root)
        self.writes = []

    def _record(self, path, text):
        self.writes.append((os.path.relpath(os.path.realpath(path),
                                            os.path.realpath(self.root)),
                            text))

    def write_driver_override(self, pci_address, driver):
        super().write_driver_override(pci_address, driver)
        self._record(self._p("sys", "bus", "pci", "devices", pci_address,
                             "driver_override"),
                     driver + "\n" if driver else "\n")

    def unbind(self, pci_address):
        drv = self.current_driver(pci_address)
        super().unbind(pci_address)
        if drv is not None:
            self._record(self._p("sys", "bus", "pci", "drivers", drv,
                                 "unbind"), pci_address)
            self.kernel.step()

    def bind(self, pci_address, driver):
        super().bind(pci_address, driver)
        self._record(self._p("sys", "bus", "pci", "drivers", driver, "bind"),
                     pci_address)
        self.kernel.step()


@pytest.mark.parametrize("groups", [None, {1: 0}],
                         ids=["own-groups", "shared-group"])
def test_sysfs_writes_equal_reference(tmp_path, groups):
    """configure GPU 0, unconfigure it, configure GPU 1: the same writes
    in the same order on both trees, after NAME_MAP."""
    gpus = gpuinfo.default_fake_gpus(2)
    chips = [dataclasses.replace(c, pci_address=addr(g))
             for c, g in zip(reference_chips(gpus), gpus)]
    ref_root = make_fake_sysfs(str(tmp_path / "ref"), chips)
    if groups:   # chip 1 into chip 0's group, as the reference's tests do
        dev1 = os.path.join(ref_root, "sys", "bus", "pci", "devices",
                            chips[1].pci_address)
        g0 = os.path.join(ref_root, "sys", "kernel", "iommu_groups", "0")
        os.unlink(os.path.join(dev1, "iommu_group"))
        os.symlink(g0, os.path.join(dev1, "iommu_group"))
        os.symlink(dev1, os.path.join(g0, "devices", chips[1].pci_address))
    ref_fs = RefRecordingSysfs(ref_root)
    ref = RefManager(ref_fs)
    port_root = make_fake_pci_tree(str(tmp_path / "port"), gpus,
                                   groups=groups)
    port_fs = kernel_pci_sysfs(port_root)
    port = manager(port_fs)
    assert ref.configure(chips[0]) == port.configure(gpus[0]) == "0"
    ref.unconfigure(chips[0])
    port.unconfigure(gpus[0])
    assert ref.configure(chips[1]) == port.configure(gpus[1])
    mapped = []
    for path, text in ref_fs.writes:
        for a, b in NAME_MAP:
            path, text = path.replace(a, b), text.replace(a, b)
        mapped.append((path, text))
    assert port_fs.writes == mapped
    assert len(mapped) == (24 if groups else 12)   # 4 per function rebound
    assert [port_fs.current_driver(addr(g)) for g in gpus] == [
        ref_fs.current_driver(c.pci_address).replace("tpu-accel",
                                                      NVIDIA_DRIVER)
        for c in chips]
