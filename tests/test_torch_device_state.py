"""Port parity: tpu_dra_torch.gpuplugin.device_state (with its deviceinfo,
checkpoint, sharing and CDI) against tpu_dra.tpuplugin.device_state, on
the CPU.

Both DeviceStates run over their fake backends with the same node (the
port's 8-GPU HGX H100 inventory; reference chips with the same indices,
UUIDs, coordinates and topology) and get the same claims, the reference's
mapped to the port's names (test_torch_cdi.NAME_MAP). Compared exactly
after that map: the kubelet-facing results, the checkpoint records (live
and after a restart from the journal), the claim env (minus the keys one
side has alone, REFERENCE_ONLY / PORT_ONLY, checked on their own, and the
per-trace traceparent), the backends' settings, the rollbacks and the
quarantine ledger. What the port refuses because it is not yet ported
(MPS, MIG) is held to "nothing was prepared".
"""

import dataclasses
import json

import pytest
import torch

from tpu_dra.api import types as ref_types
from tpu_dra.cdi.handler import CDIHandler as RefCDI
from tpu_dra.infra import featuregates as ref_gates
from tpu_dra.infra.faults import FAULTS as REF_FAULTS
from tpu_dra.infra.faults import Always as RefAlways
from tpu_dra.native.tpuinfo import FakeBackend as RefFake
from tpu_dra.tpuplugin.checkpoint import CheckpointManager as RefCkpt
from tpu_dra.tpuplugin.device_state import DeviceState as RefState
from tpu_dra.tpuplugin.sharing import TimeSlicingManager as RefTS
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler as PortCDI
from tpu_dra_torch.gpuplugin.checkpoint import (
    PREPARE_COMPLETED, CheckpointManager as PortCkpt,
)
from tpu_dra_torch.gpuplugin.device_state import DeviceState as PortState
from tpu_dra_torch.gpuplugin.sharing import TimeSlicingManager as PortTS
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.infra.faults import Always as PortAlways
from tpu_dra_torch.native import gpuinfo

from test_torch_cdi import (
    PORT_ONLY, REFERENCE_ONLY, TRACE_KEY, reference_chips, split_env,
    to_port,
)

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


class Node:
    """The reference's and the port's DeviceState over one node."""

    def __init__(self, tmp, *, ts=False, n_gpus=8, **kw):
        self.tmp = tmp
        self.kw = kw
        self.gpus = gpuinfo.default_fake_gpus(n_gpus)
        self.ref_backend = RefFake(reference_chips(self.gpus))
        self.port_backend = gpuinfo.FakeBackend(self.gpus)
        self.ts = ts
        self.ref_cdi = RefCDI(str(tmp / "ref-cdi"),
                              driver_root=str(tmp / "drv"))
        self.port_cdi = PortCDI(str(tmp / "port-cdi"),
                                driver_root=str(tmp / "drv"))
        self.start()

    def start(self):
        self.ref_ckpt = RefCkpt(str(self.tmp / "ref-plugin"))
        self.port_ckpt = PortCkpt(str(self.tmp / "port-plugin"))
        self.ref = RefState(
            backend=self.ref_backend, cdi=self.ref_cdi,
            checkpoints=self.ref_ckpt,
            driver_name=ref_types.TPU_DRIVER_NAME, node_name="node-a",
            ts_manager=RefTS(self.ref_backend) if self.ts else None,
            **self.kw)
        self.port = PortState(
            backend=self.port_backend, cdi=self.port_cdi,
            checkpoints=self.port_ckpt,
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a",
            ts_manager=PortTS(self.port_backend) if self.ts else None,
            **self.kw)

    def restart(self):
        self.close()
        self.start()

    def close(self):
        self.ref.close()
        self.port.close()

    def prepare(self, ref_claims):
        """Both sides' prepare_batch on the same claims; returns the
        results (reference mapped to port names, port)."""
        ref = self.ref.prepare_batch(ref_claims)
        port = self.port.prepare_batch([to_port(c) for c in ref_claims])
        return ({uid: to_port(dataclasses.asdict(r))
                 for uid, r in ref.items()},
                {uid: dataclasses.asdict(r) for uid, r in port.items()})

    def records(self):
        """Both sides' checkpoint claims: uid -> (state, devices)."""
        def of(state):
            return {uid: [c.state, c.devices] for uid, c in
                    state.checkpoint_snapshot().claims.items()}
        return to_port(of(self.ref)), of(self.port)

    def claim_env(self, uid):
        def env(cdi):
            with open(cdi.claim_spec_path(uid)) as f:
                spec = json.load(f)
            return dict(e.split("=", 1) for e in
                        spec["devices"][0]["containerEdits"]["env"])
        return to_port(env(self.ref_cdi)), env(self.port_cdi)


def ref_claim(uid, devices, configs=()):
    return {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"uid": uid, "name": f"c-{uid}", "namespace": "ns"},
        "status": {"allocation": {"devices": {
            "results": [{"request": "tpu", "driver": ref_types.TPU_DRIVER_NAME,
                         "pool": "node-a", "device": f"chip-{i}"}
                        for i in devices],
            "config": [{"source": "FromClaim", "requests": [],
                        "opaque": {"driver": ref_types.TPU_DRIVER_NAME,
                                   "parameters": p}} for p in configs],
        }}},
    }


def tpu_config(**fields):
    return {"apiVersion": ref_types.API_VERSION, "kind": "TpuConfig",
            **fields}


@pytest.fixture
def node(tmp_path):
    n = Node(tmp_path)
    yield n
    n.close()


def assert_same_claim(node, uid, gpus):
    ref_env, port_env = node.claim_env(uid)
    ref_shared, ref_own, ref_trace = split_env(ref_env)
    port_shared, port_own, port_trace = split_env(port_env)
    assert port_shared == ref_shared
    assert set(ref_own) == set(REFERENCE_ONLY) - {"TPU_SKIP_MDS_QUERY"}
    uuids = ",".join(node.gpus[i].uuid for i in sorted(gpus))
    assert port_own == dict.fromkeys(PORT_ONLY, uuids)
    assert ref_trace and port_trace


class TestPrepare:
    @pytest.mark.parametrize("gpus", [[3], list(range(8))],
                             ids=["one-gpu", "eight-gpus"])
    def test_single_claim(self, node, gpus):
        ref, port = node.prepare([ref_claim("u1", gpus)])
        assert port == ref
        assert port["u1"]["error"] == ""
        assert len(port["u1"]["devices"]) == len(gpus)
        ref_rec, port_rec = node.records()
        assert port_rec == ref_rec
        assert port_rec["u1"][0] == PREPARE_COMPLETED
        assert port_rec["u1"][1][0]["gpu_uuid"] == node.gpus[gpus[0]].uuid
        assert_same_claim(node, "u1", gpus)
        # The default config reaches no privileged setter.
        assert node.port_backend.timeslices == {}
        assert node.port_backend.exclusive == {}

    def test_idempotent_replay(self, node):
        claim = ref_claim("u1", [0, 1])
        first = node.prepare([claim])
        a0 = node.port_ckpt.journal_appends
        second = node.prepare([claim])
        assert second == first
        assert node.port_ckpt.journal_appends == a0

    def test_batch_of_64(self, node):
        claims = [ref_claim(f"u{k:02d}", [k % 8]) for k in range(64)]
        a0 = (node.ref_ckpt.journal_appends, node.port_ckpt.journal_appends)
        ref, port = node.prepare(claims)
        assert port == ref
        assert all(r["error"] == "" for r in port.values())
        assert len(port) == 64
        ref_rec, port_rec = node.records()
        assert port_rec == ref_rec
        for k in (0, 9, 63):
            assert_same_claim(node, f"u{k:02d}", [k % 8])
        # One group-committed terminal record for the whole batch.
        assert node.ref_ckpt.journal_appends - a0[0] == 1
        assert node.port_ckpt.journal_appends - a0[1] == 1
        uids = [c["metadata"]["uid"] for c in claims]
        assert node.port.unprepare_batch(uids) \
            == node.ref.unprepare_batch(uids) == dict.fromkeys(uids)
        assert node.port_cdi.list_claim_uids() == []
        assert node.port.prepared_claim_uids() == []
        assert node.records() == ({}, {})

    def test_unknown_device_and_foreign_driver(self, node):
        bad = ref_claim("u1", [9])
        foreign = ref_claim("u2", [0])
        foreign["status"]["allocation"]["devices"]["results"][0]["driver"] \
            = "other.dev"
        ref, port = node.prepare([bad, foreign])
        assert port == ref
        assert "not on this node" in port["u1"]["error"]
        assert "no allocation results" in port["u2"]["error"]
        assert node.records() == ({}, {})

    def test_config_precedence(self, node):
        """Class < claim, later > earlier: the claim's last config wins."""
        port_gates.Features.set_from_string("TimeSlicingSettings=true")
        ref_gates.Features.set_from_string("TimeSlicingSettings=true")
        try:
            claim = ref_claim("u1", [0], configs=[
                tpu_config(), tpu_config(sharing={
                    "strategy": "TimeSlicing",
                    "timeSlicingConfig": {"interval": "Long"}})])
            claim["status"]["allocation"]["devices"]["config"].insert(0, {
                "source": "FromClass", "requests": [],
                "opaque": {"driver": ref_types.TPU_DRIVER_NAME,
                           "parameters": tpu_config()}})
            node.ref._ts_manager = RefTS(node.ref_backend)
            node.port._ts_manager = PortTS(node.port_backend)
            ref, port = node.prepare([claim])
            assert port == ref
            ref_rec, port_rec = node.records()
            assert port_rec == ref_rec
            cfg = port_rec["u1"][1][0]["config"]
            assert cfg["sharing"]["timeSlicingConfig"]["interval"] == "Long"
        finally:
            ref_gates.Features.reset()


class TestSharing:
    def test_time_slicing_on_fake_backend(self, tmp_path):
        port_gates.Features.set_from_string("TimeSlicingSettings=true")
        ref_gates.Features.set_from_string("TimeSlicingSettings=true")
        n = Node(tmp_path, ts=True)
        try:
            # Startup reconciliation: every free GPU reset to the default.
            assert n.port_backend.timeslices == dict.fromkeys(range(8), 0)
            assert n.ref_backend.timeslices == dict.fromkeys(range(8), 0)
            claim = ref_claim("u1", [1, 2], configs=[tpu_config(sharing={
                "strategy": "TimeSlicing",
                "timeSlicingConfig": {"interval": "Short"}})])
            ref, port = n.prepare([claim])
            assert port == ref and port["u1"]["error"] == ""
            ref_rec, port_rec = n.records()
            assert port_rec == ref_rec
            assert_same_claim(n, "u1", [1, 2])
            _, port_env = n.claim_env("u1")
            assert port_env["GPU_SHARING_STRATEGY"] == "time-slicing"

            # The same interval, in each side's unit.
            def by_name(values, table):
                names = {v: k for k, v in table.items()}
                return {i: names[v] for i, v in values.items()}
            assert by_name(n.port_backend.timeslices,
                           port_types.TIME_SLICE_INTERVALS) == by_name(
                n.ref_backend.timeslices, ref_types.TIME_SLICE_INTERVALS)
            assert n.port_backend.timeslices[1] == 1   # Short
            assert n.port_backend.exclusive == n.ref_backend.exclusive
            assert n.port.unprepare("u1") is n.ref.unprepare("u1") is None
            assert n.port_backend.timeslices == dict.fromkeys(range(8), 0)
            assert n.ref_backend.timeslices == dict.fromkeys(range(8), 0)
        finally:
            n.close()
            ref_gates.Features.reset()

    def test_passthrough_without_manager(self, node):
        """Manager-less passthrough: exclusive compute mode and the
        passthrough env, the claim device only."""
        port_gates.Features.set_from_string("PassthroughSupport=true")
        ref_gates.Features.set_from_string("PassthroughSupport=true")
        try:
            claim = ref_claim("u1", [4], configs=[{
                "apiVersion": ref_types.API_VERSION,
                "kind": "PassthroughConfig"}])
            ref, port = node.prepare([claim])
            assert port == ref and port["u1"]["error"] == ""
            assert port["u1"]["devices"][0]["cdi_device_ids"] == [
                "k8s.gpu.dev/claim=u1"]
            assert node.port_backend.exclusive == {4: True}
            assert node.ref_backend.exclusive == {4: True}
            ref_env, port_env = node.claim_env("u1")
            assert port_env["GPU_PASSTHROUGH"] == "true"
            assert split_env(port_env)[0] == split_env(ref_env)[0]
            node.ref.unprepare("u1")
            node.port.unprepare("u1")
            assert node.port_backend.exclusive == {4: False}
            assert node.ref_backend.exclusive == {4: False}
        finally:
            ref_gates.Features.reset()


class TestRollback:
    def test_claim_write_fault_rolls_back_only_the_loser(self, node):
        claims = [ref_claim(f"u{k}", [k]) for k in range(4)]
        loser = "u2"

        def fail_loser(claim_uid=None, **_ctx):
            if claim_uid == loser:
                raise OSError(28, "No space left on device")

        with REF_FAULTS.armed("cdi.claim_write", RefAlways(),
                              action=fail_loser):
            with PORT_FAULTS.armed("cdi.claim_write", PortAlways(),
                                   action=fail_loser):
                ref, port = node.prepare(claims)
        assert port == ref
        assert "No space left" in port[loser]["error"]
        assert all(port[u]["error"] == "" for u in ("u0", "u1", "u3"))
        ref_rec, port_rec = node.records()
        assert port_rec == ref_rec
        assert set(port_rec) == {"u0", "u1", "u3"}
        assert sorted(node.port_cdi.list_claim_uids()) == ["u0", "u1", "u3"]
        # The fault gone, the loser's retry prepares from scratch.
        ref, port = node.prepare([claims[2]])
        assert port == ref and port[loser]["error"] == ""

    def test_apply_fault_rolls_back_only_the_loser(self, node):
        claims = [ref_claim(f"u{k}", [k]) for k in range(3)]

        def fail(claim_uid=None, **_ctx):
            if claim_uid == "u0":
                raise RuntimeError("injected mid-apply failure")

        with REF_FAULTS.armed("prepare.batch_apply", RefAlways(),
                              action=fail):
            with PORT_FAULTS.armed("prepare.batch_apply", PortAlways(),
                                   action=fail):
                ref, port = node.prepare(claims)
        assert port == ref
        assert "injected" in port["u0"]["error"]
        assert node.records()[1].keys() == {"u1", "u2"}


class TestRestart:
    def test_restart_from_the_journal(self, node):
        node.prepare([ref_claim(f"u{k}", [k, k + 4]) for k in range(3)])
        node.port.unprepare("u1")
        node.ref.unprepare("u1")
        before = node.records()
        node.restart()
        after = node.records()
        assert after == before
        ref_rec, port_rec = after
        assert port_rec == ref_rec and set(port_rec) == {"u0", "u2"}
        # The recovered claims are still idempotent fast-path hits.
        ref, port = node.prepare([ref_claim("u0", [0, 4])])
        assert port == ref and port["u0"]["error"] == ""

    def test_orphan_claim_spec_collected_at_start(self, node):
        node.port_cdi.create_claim_spec_file("orphan", {"A": "1"})
        node.ref_cdi.create_claim_spec_file("orphan", {"A": "1"})
        node.restart()
        assert node.port_cdi.list_claim_uids() == []
        assert node.ref_cdi.list_claim_uids() == []


class TestQuarantine:
    def test_flapping_gpu_quarantined_and_persisted(self, tmp_path):
        n = Node(tmp_path, quarantine_threshold=2)
        try:
            for state in (n.ref, n.port):
                assert state.mark_unhealthy(5) and state.mark_healthy(5)
                state.mark_unhealthy(5)
                # A recovery does not re-admit a quarantined device.
                assert state.mark_healthy(5) == []

            def ledger(records):
                return {u: {k: v for k, v in r.items() if k != "since"}
                        for u, r in records.items()}
            ref_q = to_port(ledger(n.ref.quarantined_chips()))
            port_q = ledger(n.port.quarantined_gpus())
            assert port_q == ref_q
            assert port_q[n.gpus[5].uuid]["gpu_index"] == 5

            def names(state):
                return [d["name"] for d in state.healthy_devices()]
            assert names(n.port) == to_port(names(n.ref))
            assert "gpu-5" not in names(n.port)
            n.restart()
            assert ledger(n.port.quarantined_gpus()) == port_q
            assert to_port(ledger(n.ref.quarantined_chips())) == port_q
            assert n.port.clear_quarantine(5) == to_port(
                n.ref.clear_quarantine(5)) == ["gpu-5"]
            assert "gpu-5" in names(n.port)
        finally:
            n.close()

    def test_unpersistable_quarantine_degrades(self, tmp_path):
        n = Node(tmp_path, quarantine_threshold=1)
        try:
            with REF_FAULTS.armed("health.flap", RefAlways()):
                with PORT_FAULTS.armed("health.flap", PortAlways()):
                    n.ref.mark_unhealthy(2)
                    n.port.mark_unhealthy(2)
            assert n.port.quarantined_gpus() == {}
            assert n.ref.quarantined_chips() == {}
            assert [d["name"] for d in n.port.healthy_devices()] \
                == to_port([d["name"] for d in n.ref.healthy_devices()])
        finally:
            n.close()


class TestNotYetPorted:
    def _nothing_prepared(self, node, port_result):
        assert "not yet ported" in port_result["error"]
        assert port_result["devices"] == []
        assert node.port.prepared_claim_uids() == []
        assert node.port_cdi.list_claim_uids() == []
        assert node.port_backend.timeslices == {}
        assert node.port_backend.exclusive == {}

    def test_mps_refused_cleanly(self, node):
        port_gates.Features.set_from_string("MultiprocessSupport=true")
        a0 = node.port_ckpt.journal_appends
        claim = to_port(ref_claim("u1", [0], configs=[tpu_config(sharing={
            "strategy": "MPS", "mpsConfig": {
                "defaultActiveThreadPercentage": 50,
                "defaultPinnedDeviceMemoryLimit": "8Gi"}})]))
        res = dataclasses.asdict(node.port.prepare_batch([claim])["u1"])
        self._nothing_prepared(node, res)
        assert "MPS" in res["error"]
        assert node.port_ckpt.journal_appends == a0
        # The GPU stays free for the next claim.
        ok = node.port.prepare_batch([to_port(ref_claim("u2", [0]))])
        assert ok["u2"].error == ""

    def test_mig_config_refused(self, node):
        claim = to_port(ref_claim("u1", [0]))
        claim["status"]["allocation"]["devices"]["config"] = [{
            "source": "FromClaim", "requests": [],
            "opaque": {"driver": port_types.GPU_DRIVER_NAME, "parameters": {
                "apiVersion": port_types.API_VERSION,
                "kind": "MigDeviceConfig"}}}]
        res = dataclasses.asdict(node.port.prepare_batch([claim])["u1"])
        self._nothing_prepared(node, res)
        assert "MIG" in res["error"]

    def test_vfio_manager_refused(self, tmp_path):
        """DeviceState takes no VFIO manager in this slice: a passthrough
        claim is never rebound to vfio-pci."""
        with pytest.raises(TypeError, match="pt_manager"):
            PortState(backend=gpuinfo.FakeBackend(),
                      cdi=PortCDI(str(tmp_path / "cdi")),
                      checkpoints=PortCkpt(str(tmp_path / "cp")),
                      driver_name=port_types.GPU_DRIVER_NAME,
                      node_name="n", pt_manager=object())

    def test_mps_gated_off_is_an_unknown_strategy(self, node):
        claim = to_port(ref_claim("u1", [0], configs=[tpu_config(sharing={
            "strategy": "MPS"})]))
        res = node.port.prepare_batch([claim])["u1"]
        assert "unknown GPU sharing strategy" in res.error
        assert node.port.prepared_claim_uids() == []


class TestSpans:
    def test_claim_trace_matches_reference(self, node):
        """One claim, one tree on each side: prepare.claim with its
        sharing/guards/cdi_write/cdi_wait/cdi_io/journal children, and the
        workload's mesh.build continuing the same trace from the env."""
        from tpu_dra.infra import trace as ref_trace
        from tpu_dra.topology import meshexport as ref_me
        from tpu_dra_torch.infra import trace as port_trace
        from tpu_dra_torch.topology import meshexport as port_me

        node.prepare([ref_claim("u1", [2, 3])])
        trees = []
        for trace, me, cdi in ((ref_trace, ref_me, node.ref_cdi),
                               (port_trace, port_me, node.port_cdi)):
            with open(cdi.claim_spec_path("u1")) as f:
                env = dict(e.split("=", 1) for e in json.load(f)[
                    "devices"][0]["containerEdits"]["env"])
            assert me.plan_from_env(env).n_devices == 2
            trace_id = trace.parse_traceparent(env[TRACE_KEY])[0]
            assert trace.verify_trace(trace_id) == []
            trees.append({parent: sorted(s.name for s in kids) for
                          parent, kids in trace.span_tree(trace_id).items()})
        assert trees[1] == trees[0]
        assert trees[1][""] == ["prepare.claim"]
        assert {"prepare.cdi_write", "prepare.journal",
                "mesh.build"} <= set(trees[1]["prepare.claim"])


class TestPublishedDevices:
    def test_attributes_for_cel(self, node):
        devices = node.port.healthy_devices()
        assert [d["name"] for d in devices] == [f"gpu-{i}" for i in range(8)]
        attrs = devices[3]["attributes"]
        assert attrs["uuid"] == {"string": node.gpus[3].uuid}
        assert attrs["productName"] == {"string": "NVIDIA H100 80GB HBM3"}
        assert attrs["index"] == {"int": 3}
        assert attrs["minor"] == {"int": 3}
        assert attrs["pciBusID"] == {"string": node.gpus[3].pci_bus_id}
        assert attrs["cudaComputeCapability"] == {"version": "9.0.0"}
        assert attrs["clique"] == {"string": ""}
        assert attrs["coordX"] == {"int": 3}
        assert attrs["fabricTopology"] == {"string": "8x1x1"}
        assert devices[3]["capacity"] == {"memory": {"value": str(80 << 30)}}
        ref_devices = node.ref.healthy_devices()
        for key in ("coordX", "coordY", "coordZ", "workerIndex", "uuid"):
            assert [d["attributes"][key] for d in devices] == \
                [d["attributes"][key] for d in ref_devices]


class TestCheckpointFormat:
    def _image(self):
        from tpu_dra_torch.gpuplugin.checkpoint import (
            Checkpoint, PreparedClaim,
        )
        cp = Checkpoint()
        cp.claims["u1"] = PreparedClaim(
            uid="u1", state=PREPARE_COMPLETED, name="c", namespace="ns",
            devices=[{"device": "gpu-3", "gpu_index": 3}])
        cp.quarantine["GPU-x"] = {"gpu_index": 5, "flaps": 3}
        return cp

    def test_reference_reads_the_ports_image(self, tmp_path):
        """The port writes the reference's v2 slot and journal format."""
        port = PortCkpt(str(tmp_path))
        try:
            port.store(self._image())
        finally:
            port.close()
        ref = RefCkpt(str(tmp_path))
        try:
            cp = ref.load()
        finally:
            ref.close()
        assert cp.claims["u1"].to_v2() == self._image().claims["u1"].to_v2()
        assert cp.quarantine == {"GPU-x": {"gpu_index": 5, "flaps": 3}}

    def test_older_formats_refused(self, tmp_path):
        """No v1 document and no seq-less slot: this package never wrote
        them, so a slot holding one is corrupt, not an older driver's."""
        import zlib

        from tpu_dra_torch.gpuplugin.checkpoint import (
            Checkpoint, CheckpointError,
        )
        with pytest.raises(CheckpointError, match="version 'v1'"):
            Checkpoint.from_doc({"version": "v1", "preparedClaims": {}})
        doc = self._image().to_v2_doc()
        payload = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        (tmp_path / "checkpoint.json").write_text(json.dumps(
            {"checksum": zlib.crc32(payload.encode()), "data": doc}))
        mgr = PortCkpt(str(tmp_path))
        try:
            with pytest.raises(CheckpointError, match="no valid slot"):
                mgr.load()
        finally:
            mgr.close()


def test_port_registers_only_the_gates_it_reads():
    assert port_gates.Features.known() == [
        "MultiprocessSupport", "NVMLDeviceHealthCheck", "PassthroughSupport",
        "TimeSlicingSettings"]
    ref_known = to_port(list(ref_gates.Features.known()))
    assert set(port_gates.Features.known()) <= set(ref_known)
    # Each gate's default is the reference's (the health check on).
    ref_defaults = to_port(ref_gates.Features.snapshot())
    assert {n: ref_defaults[n] for n in port_gates.Features.known()} \
        == port_gates.Features.snapshot()
    assert port_gates.Features.enabled(port_gates.NVMLDeviceHealthCheck)
    with pytest.raises(ValueError, match="unknown feature gate"):
        port_gates.Features.set_from_string("TopologyAwareScheduling=true")
