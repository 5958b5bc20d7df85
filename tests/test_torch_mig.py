"""Port parity: MIG devices (tpu_dra_torch.gpuplugin.deviceinfo's MIG
placements, DeviceState's dynamic MIG prepare on native.gpuinfo's
FakeBackend) against the reference's subslices (tpu_dra.tpuplugin.
deviceinfo), on the CPU.

The placements are held against the H100 80GB's GPU-instance profile
table as NVIDIA's MIG User Guide lists it. A MIG device renders as the
reference renders a subslice of the same GPU, after the name map
SUBSLICE_MAP (a subslice of `size` of a chip's 8 cores at core `start`
stands for the placement of `size` of the GPU's 8 memory slices at
`start`). Prepare and unprepare run through DeviceState on the fake
backend, whose create refuses overlapping memory slices as the card
does: the instance, its env and device nodes, the overlap refusals (which
leave nothing behind), the restart that rolls back a claim interrupted
after its intent record, and the startup reconciliation that destroys an
instance no claim holds.
"""

import dataclasses
import re

import pytest
import torch

from tpu_dra.native.tpuinfo import Chip
from tpu_dra.tpuplugin import deviceinfo as ref_deviceinfo
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.gpuplugin import deviceinfo
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.workloads import meshbuild

from test_torch_cdi import reference_chips

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

# The H100 80GB's GPU-instance profiles (NVIDIA MIG User Guide): name ->
# (placements, memory slices each, starts).
H100_TABLE = {
    "1g.10gb": (7, 1, (0, 1, 2, 3, 4, 5, 6)),
    "1g.20gb": (4, 2, (0, 2, 4, 6)),
    "2g.20gb": (3, 2, (0, 2, 4)),
    "3g.40gb": (2, 4, (0, 4)),
    "4g.40gb": (1, 4, (0,)),
    "7g.80gb": (1, 8, (0,)),
}
# Reference subslice attribute/capacity -> port MIG attribute/capacity.
SUBSLICE_MAP = {"coreStart": "placementStart", "hbm": "memory",
                "subslice": "mig"}
DNS_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


def mig_gpus(n=2, mig=(1,)):
    """`n` fake H100s, those in `mig` in MIG mode."""
    return [dataclasses.replace(g, mig_mode=g.index in mig)
            for g in gpuinfo.default_fake_gpus(n)]


class TestPlacements:
    def test_h100_table(self):
        backend = gpuinfo.FakeBackend(mig_gpus())
        gpu = backend.get_gpu(1)
        placements = deviceinfo.mig_placements(gpu, backend.mig_profiles(1))
        assert len(placements) == sum(n for n, _, _ in H100_TABLE.values())
        for name, (count, size, starts) in H100_TABLE.items():
            mine = [p for p in placements if p.profile == name]
            assert len(mine) == count
            assert tuple(p.start for p in mine) == starts
            assert {p.size for p in mine} == {size}
            assert all(p.memory_bytes == gpu.memory_bytes * size // 8
                       for p in mine)
            # No two placements of one profile overlap, and each fits.
            slices = [s for p in mine for s in p.slices]
            assert len(slices) == len(set(slices))
            assert max(slices) < deviceinfo.MIG_MEMORY_SLICES

    def test_only_mig_mode_gpus_advertise_mig_devices(self):
        backend = gpuinfo.FakeBackend(mig_gpus(2, mig=(1,)))
        devices = deviceinfo.enumerate_allocatable(
            backend.gpus(), mig_profiles=backend.mig_profiles)
        assert sorted(n for n, d in devices.items()
                      if d.type == deviceinfo.DEVICE_TYPE_GPU) == [
            "gpu-0", "gpu-1"]
        migs = [d for d in devices.values()
                if d.type == deviceinfo.DEVICE_TYPE_MIG]
        assert len(migs) == 18 and {d.gpu.index for d in migs} == {1}
        assert deviceinfo.enumerate_allocatable(
            backend.gpus(), include_mig=False,
            mig_profiles=backend.mig_profiles).keys() == {"gpu-0", "gpu-1"}
        # A GPU with MIG off answers no profile (as NVML does).
        with pytest.raises(gpuinfo.NvmlError):
            backend.mig_profiles(0)

    def test_names_are_dns_labels(self):
        backend = gpuinfo.FakeBackend(mig_gpus())
        names = list(deviceinfo.enumerate_allocatable(
            backend.gpus(), mig_profiles=backend.mig_profiles))
        assert "gpu-1-mig-3g40gb-4" in names
        assert all(DNS_LABEL.match(n) and len(n) <= 63 for n in names)

    @pytest.mark.parametrize("profile,start,cores", [
        ("3g.40gb", 4, 4), ("1g.10gb", 6, 1), ("7g.80gb", 0, 8)])
    def test_rendering_against_reference_subslice(self, profile, start,
                                                  cores):
        """The reference's subslice of `cores` of a chip's 8 cores at
        `start`, holding `cores` eighths of its HBM, against the MIG
        device of the same memory share at the same start."""
        backend = gpuinfo.FakeBackend(mig_gpus())
        gpu = backend.get_gpu(1)
        dev = deviceinfo.enumerate_allocatable(
            backend.gpus(), mig_profiles=backend.mig_profiles)[
            f"gpu-1-mig-{profile.replace('.', '')}-{start}"]
        chip = dataclasses.replace(reference_chips([gpu])[0],
                                   tensorcore_count=8)
        ref = ref_deviceinfo.AllocatableDevice(
            type=ref_deviceinfo.DEVICE_TYPE_SUBSLICE, chip=chip,
            subslice=ref_deviceinfo.SubslicePlacement(chip, cores, start))
        ref_api, port_api = ref.to_resource_api(), dev.to_resource_api()

        def mapped(d):
            return {SUBSLICE_MAP.get(k, k): v for k, v in d.items()}
        ref_attrs = mapped(ref_api["attributes"])
        ref_attrs["type"] = {"string": SUBSLICE_MAP[
            ref_attrs["type"]["string"]]}
        port_attrs = port_api["attributes"]
        for key in ("type", "uuid", "parentUUID", "placementStart",
                    "workerIndex", "coordX", "coordY", "coordZ"):
            assert port_attrs[key] == ref_attrs[key], key
        assert port_attrs["profile"] == {"string": profile}
        assert set(ref_attrs) - set(port_attrs) == {
            "generation", "driverVersion", "pciAddress", "sliceID",
            "sliceTopology"}
        assert mapped(ref_api["capacity"])["memory"] == \
            port_api["capacity"]["memory"]
        assert DNS_LABEL.match(port_api["name"]) \
            and DNS_LABEL.match(ref_api["name"])


class Node:
    """A port DeviceState over a fake node whose GPU 1 is in MIG mode."""

    def __init__(self, tmp, backend=None):
        self.tmp = tmp
        self.backend = backend or gpuinfo.FakeBackend(mig_gpus())
        self.cdi = CDIHandler(str(tmp / "cdi"), driver_root=str(tmp / "drv"))
        self.start()

    def start(self):
        self.ckpt = CheckpointManager(str(self.tmp / "plugin"))
        self.state = DeviceState(
            backend=self.backend, cdi=self.cdi, checkpoints=self.ckpt,
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a")

    def restart(self):
        self.state.close()
        self.start()

    def env(self, uid):
        spec = self.cdi.read_spec(self.cdi.claim_spec_path(uid))
        edits = spec["devices"][0]["containerEdits"]
        return (dict(e.split("=", 1) for e in edits["env"]),
                edits.get("deviceNodes", []))

    def left(self):
        return (self.backend.mig_devices(1), self.state.prepared_claim_uids(),
                self.cdi.list_claim_uids())


def claim(uid, devices, configs=()):
    return {
        "metadata": {"uid": uid, "name": uid, "namespace": "ns"},
        "status": {"allocation": {"devices": {
            "results": [{"request": "r", "driver": port_types.GPU_DRIVER_NAME,
                         "pool": "node-a", "device": d} for d in devices],
            "config": [{"source": "FromClaim", "requests": [],
                        "opaque": {"driver": port_types.GPU_DRIVER_NAME,
                                   "parameters": p}} for p in configs]}}},
    }


MIG_CONFIG = {"apiVersion": port_types.API_VERSION,
              "kind": "MigDeviceConfig"}


@pytest.fixture
def node(tmp_path):
    n = Node(tmp_path)
    yield n
    n.state.close()


class TestPrepare:
    @pytest.mark.parametrize("configs", [(), (MIG_CONFIG,)],
                             ids=["default-config", "mig-config"])
    def test_instance_created_and_destroyed(self, node, configs):
        res = node.state.prepare(claim("u1", ["gpu-1-mig-3g40gb-4"],
                                       configs))
        assert res.error == ""
        (live,) = node.backend.mig_devices(1)
        assert (live.profile, live.start, live.size) == ("3g.40gb", 4, 4)
        env, nodes = node.env("u1")
        assert env["CUDA_VISIBLE_DEVICES"] == live.uuid
        assert env["NVIDIA_VISIBLE_DEVICES"] == live.uuid
        assert live.uuid.startswith("MIG-")
        assert env["GPU_VISIBLE_INDICES"] == "1"
        gpu = node.backend.get_gpu(1)
        gi_cap, ci_cap = live.caps
        assert [n["path"] for n in nodes] == [
            f"/dev/nvidia-caps/nvidia-cap{gi_cap}",
            f"/dev/nvidia-caps/nvidia-cap{ci_cap}",
            "/dev/nvidiactl", gpu.dev_path]
        (record,) = node.state.checkpoint_snapshot().claims["u1"].devices
        assert record["type"] == "mig"
        assert record["mig"] == {"profile": "3g.40gb", "start": 4,
                                 "size": 4, "gi": live.gi, "ci": live.ci,
                                 "uuid": live.uuid}
        assert record["config"]["kind"] == "MigDeviceConfig"
        # The record survives a restart, and the instance with it.
        node.restart()
        assert node.backend.mig_devices(1) == [live]
        assert node.state.unprepare("u1") is None
        assert node.left() == ([], [], [])

    def test_mig_uuid_reaches_the_workload_devices(self, node):
        node.state.prepare(claim("u1", ["gpu-1-mig-1g10gb-3"]))
        env, _ = node.env("u1")
        assert meshbuild.devices_from_env(env, "cpu") == [
            torch.device("cpu")]
        uuid = env["CUDA_VISIBLE_DEVICES"]
        assert meshbuild.normalize_uuid(uuid) == uuid[4:].lower()

    def test_disjoint_placements_coexist(self, node):
        for uid, dev in (("u1", "gpu-1-mig-3g40gb-0"),
                         ("u2", "gpu-1-mig-3g40gb-4")):
            assert node.state.prepare(claim(uid, [dev])).error == ""
        assert [d.start for d in node.backend.mig_devices(1)] == [0, 4]
        assert node.state.unprepare("u1") is None
        assert [d.start for d in node.backend.mig_devices(1)] == [4]

    @pytest.mark.parametrize("first,second,holder", [
        ("gpu-1-mig-3g40gb-4", "gpu-1-mig-1g10gb-5", "overlaps"),
        ("gpu-1", "gpu-1-mig-1g10gb-0", "held whole"),
        ("gpu-1-mig-1g10gb-0", "gpu-1", "cannot be claimed whole"),
    ], ids=["overlapping-slices", "mig-on-whole-gpu", "whole-gpu-on-mig"])
    def test_overlap_refused_and_nothing_left(self, node, first, second,
                                              holder):
        assert node.state.prepare(claim("u1", [first])).error == ""
        before = node.backend.mig_devices(1)
        res = node.state.prepare(claim("u2", [second]))
        assert holder in res.error and "claim u1" in res.error
        assert res.devices == []
        assert node.backend.mig_devices(1) == before
        assert node.state.prepared_claim_uids() == ["u1"]
        assert node.cdi.list_claim_uids() == ["u1"]

    def test_two_mig_devices_of_one_gpu_refused(self, node):
        res = node.state.prepare(claim("u1", ["gpu-1-mig-1g10gb-0",
                                              "gpu-1-mig-1g10gb-1"]))
        assert "at most one MIG device" in res.error
        assert node.left() == ([], [], [])

    def test_gpu_config_does_not_apply_to_a_mig_device(self, node):
        cfg = {"apiVersion": port_types.API_VERSION, "kind": "GpuConfig"}
        c = claim("u1", ["gpu-1-mig-1g10gb-0"], [cfg])
        c["status"]["allocation"]["devices"]["config"][0]["requests"] = ["r"]
        res = node.state.prepare(c)
        assert "does not apply to mig device" in res.error
        assert node.left() == ([], [], [])

    def test_mig_config_validation(self):
        port_gates.Features.set_from_string(
            "TimeSlicingSettings=true,MultiprocessSupport=true")
        ok = port_types.MigDeviceConfig(sharing=port_types.GpuSharing(
            strategy=port_types.TimeSlicingStrategy))
        ok.normalize()
        ok.validate()
        assert ok.sharing.time_slicing_config is None
        for sharing in (
                port_types.GpuSharing(strategy=port_types.MpsStrategy),
                port_types.GpuSharing(
                    strategy=port_types.TimeSlicingStrategy,
                    time_slicing_config=port_types.TimeSlicingConfig())):
            with pytest.raises(port_types.ValidationError, match="MIG"):
                port_types.MigDeviceConfig(sharing=sharing).validate()


class _Crash(BaseException):
    """A process death: no `except Exception` in prepare catches it."""


def crash_at_terminal_commit(ckpt):
    """Make `ckpt` die at the first terminal journal record, after the
    intent record (and every side effect) of a hazardous prepare."""
    commit = ckpt.journal_commit

    def dying(cp, *, present=(), absent=(), intent=False, quarantine=False):
        if not intent and present:
            raise _Crash()
        return commit(cp, present=present, absent=absent, intent=intent,
                      quarantine=quarantine)
    ckpt.journal_commit = dying


class TestRestart:
    def test_crash_after_intent_rolled_back(self, node):
        crash_at_terminal_commit(node.ckpt)
        with pytest.raises(_Crash):
            node.state.prepare(claim("u1", ["gpu-1-mig-3g40gb-0"]))
        assert len(node.backend.mig_devices(1)) == 1   # leaked by the crash
        node.ckpt.journal_commit = None                # the process is gone
        node.start()
        assert node.left() == ([], [], [])
        # The claim's retry prepares from scratch.
        assert node.state.prepare(claim("u1", ["gpu-1-mig-3g40gb-0"])
                                  ).error == ""

    def test_unheld_instance_destroyed_at_start(self, node):
        assert node.state.prepare(claim("u1", ["gpu-1-mig-3g40gb-4"])
                                  ).error == ""
        leaked = node.backend.create_mig_device(1, "2g.20gb", 0)
        assert len(node.backend.mig_devices(1)) == 2
        node.restart()
        (kept,) = node.backend.mig_devices(1)
        assert kept.start == 4 and kept.gi != leaked.gi
        assert node.state.prepared_claim_uids() == ["u1"]
