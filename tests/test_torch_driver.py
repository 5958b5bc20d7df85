"""Port parity: tpu_dra_torch.gpuplugin.driver.GpuDriver (with the
kubelet plugin's server, transports, pipeline, flock, publish queue and
health monitor) against tpu_dra.tpuplugin.driver.TpuDriver, on the CPU.

Both drivers run over their fake backends with the same node (the port's
8-GPU HGX H100 inventory; reference chips with the same indices, UUIDs,
coordinates and topology, test_torch_cdi.reference_chips), each against
its own FakeCluster holding the same claims (the reference's mapped to
the port's names for the port, test_torch_cdi.NAME_MAP). A test acts as
kubelet over BOTH transports, gRPC and framed (parametrised as the
reference's test_e2e_prepare.py harness is). Compared exactly after the
map: the responses, the claim env (minus the keys one side has alone and
the traceparent), the checkpoint records, the published slices' shared
parts, the quarantine ledger. Every socket client has its own timeout.
"""

import threading

import pytest
import torch

from tpu_dra.api import types as ref_types
from tpu_dra.cdi.handler import CDIHandler as RefCDI
from tpu_dra.infra import featuregates as ref_gates
from tpu_dra.k8s import FakeCluster as RefCluster
from tpu_dra.k8s import RESOURCECLAIMS as REF_CLAIMS
from tpu_dra.k8s import RESOURCESLICES as REF_SLICES
from tpu_dra.kubeletplugin import server as ref_server
from tpu_dra.kubeletplugin.gen import dra_v1_pb2 as dra
from tpu_dra.kubeletplugin.gen import pluginregistration_pb2 as reg
from tpu_dra.kubeletplugin.pipeline import RpcPipeline as RefPipeline
from tpu_dra.native.tpuinfo import FakeBackend as RefFake
from tpu_dra.native.tpuinfo import HealthEvent as RefEvent
from tpu_dra.tpuplugin.checkpoint import CheckpointManager as RefCkpt
from tpu_dra.tpuplugin.device_state import DeviceState as RefState
from tpu_dra.tpuplugin.driver import TpuDriver
from tpu_dra.tpuplugin.sharing import TimeSlicingManager as RefTS
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler as PortCDI
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager as PortCkpt
from tpu_dra_torch.gpuplugin.device_state import DeviceState as PortState
from tpu_dra_torch.gpuplugin.driver import GpuDriver
from tpu_dra_torch.gpuplugin.sharing import TimeSlicingManager as PortTS
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.k8s import RESOURCECLAIMS, RESOURCESLICES, FakeCluster
from tpu_dra_torch.kubeletplugin import server as port_server
from tpu_dra_torch.kubeletplugin import wire
from tpu_dra_torch.kubeletplugin.pipeline import RpcPipeline
from tpu_dra_torch.native import gpuinfo

from test_torch_cdi import (
    PORT_ONLY, REFERENCE_ONLY, reference_chips, split_env, to_port,
)
from test_torch_wire import ref_to_dict

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

TIMEOUT_S = 30.0   # every client call's bound: a hang fails one test


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


class Node:
    """The reference's TpuDriver and the port's GpuDriver over one node,
    each with its own cluster, state dirs and kubelet-side stubs."""

    def __init__(self, tmp, transport, *, ts=False, publish_wait=5.0,
                 quarantine_threshold=3, ref_reactors=(), port_reactors=()):
        self.tmp, self.transport = tmp, transport
        self.gpus = gpuinfo.default_fake_gpus(8)
        self.ref_backend = RefFake(reference_chips(self.gpus))
        self.port_backend = gpuinfo.FakeBackend(self.gpus)
        self.ref_cluster, self.port_cluster = RefCluster(), FakeCluster()
        self.ref_cluster.reactors.extend(ref_reactors)
        self.port_cluster.reactors.extend(port_reactors)
        self.ref_cdi = RefCDI(str(tmp / "ref-cdi"),
                              driver_root=str(tmp / "drv"))
        self.port_cdi = PortCDI(str(tmp / "port-cdi"),
                                driver_root=str(tmp / "drv"))
        self.ref_state = RefState(
            backend=self.ref_backend, cdi=self.ref_cdi,
            checkpoints=RefCkpt(str(tmp / "rp")),
            driver_name=ref_types.TPU_DRIVER_NAME, node_name="node-a",
            ts_manager=RefTS(self.ref_backend) if ts else None,
            quarantine_threshold=quarantine_threshold)
        self.port_state = PortState(
            backend=self.port_backend, cdi=self.port_cdi,
            checkpoints=PortCkpt(str(tmp / "pp")),
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a",
            ts_manager=PortTS(self.port_backend) if ts else None,
            quarantine_threshold=quarantine_threshold)
        self.ref = TpuDriver(
            state=self.ref_state, client=self.ref_cluster,
            driver_name=ref_types.TPU_DRIVER_NAME, node_name="node-a",
            plugin_dir=str(tmp / "rp"),
            registry_dir=str(tmp / "rr"))
        self.port = GpuDriver(
            state=self.port_state, client=self.port_cluster,
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a",
            plugin_dir=str(tmp / "pp"),
            registry_dir=str(tmp / "pr"))
        self.ref.start(publish_wait=publish_wait)
        self.port.start(publish_wait=publish_wait)
        self._conns = []
        self.ref_stubs = self._stubs(ref_server, self.ref)
        self.port_stubs = self._stubs(port_server, self.port)

    def _stubs(self, server, driver):
        if self.transport == "grpc":
            conn, prepare, unprepare = server.kubelet_stubs(
                driver.server.dra_socket)

            def bounded(fn):
                return lambda req: fn(req, timeout=TIMEOUT_S)
            prepare, unprepare = bounded(prepare), bounded(unprepare)
        else:
            conn, prepare, unprepare = server.framed_stubs(
                driver.server.fast_socket, timeout_s=TIMEOUT_S)
        self._conns.append(conn)
        return prepare, unprepare

    def close(self):
        for conn in self._conns:
            conn.close()
        self.ref.shutdown()
        self.port.shutdown()

    # -- claims ---------------------------------------------------------

    def create(self, uid, gpus, configs=(), name=None):
        """The same allocated claim in both clusters (the reference's
        names in its own, mapped for the port's); returns the reference's
        object."""
        obj = {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"uid": uid, "name": name or f"c-{uid}",
                         "namespace": "default"},
            "spec": {"devices": {"requests": [{"name": "tpu"}]}},
            "status": {"allocation": {"devices": {
                "results": [{"request": "tpu",
                             "driver": ref_types.TPU_DRIVER_NAME,
                             "pool": "node-a", "device": f"chip-{i}"}
                            for i in gpus],
                "config": [{"source": "FromClaim", "requests": [],
                            "opaque": {"driver": ref_types.TPU_DRIVER_NAME,
                                       "parameters": p}}
                           for p in configs]}}},
        }
        self.ref_cluster.create(REF_CLAIMS, obj)
        self.port_cluster.create(RESOURCECLAIMS, to_port(obj))
        return obj

    def _call(self, kind, refs):
        """One RPC of `kind` to both plugins for the claim refs
        [(uid, name)]: (reference response mapped to port names, port
        response), as plain values."""
        ref_req = (dra.NodePrepareResourcesRequest() if kind == "prepare"
                   else dra.NodeUnprepareResourcesRequest())
        for uid, name in refs:
            c = ref_req.claims.add()
            c.uid, c.name, c.namespace = uid, name, "default"
        port_cls = (wire.NodePrepareResourcesRequest if kind == "prepare"
                    else wire.NodeUnprepareResourcesRequest)
        port_req = port_cls(claims=[wire.Claim(namespace="default", uid=u,
                                               name=n) for u, n in refs])
        i = 0 if kind == "prepare" else 1
        ref = self.ref_stubs[i](ref_req)
        port = self.port_stubs[i](port_req)
        return to_port(ref_to_dict(ref)), port.to_dict()

    def prepare(self, *refs):
        return self._call("prepare", refs)

    def unprepare(self, *refs):
        return self._call("unprepare", refs)

    # -- state ----------------------------------------------------------

    def records(self):
        def of(state):
            return {uid: [c.state, c.devices] for uid, c in
                    state.checkpoint_snapshot().claims.items()}
        return to_port(of(self.ref_state)), of(self.port_state)

    def slices(self):
        """Both published slices' shared parts: (reference mapped, port)."""
        def shared(s):
            spec = s["spec"]
            return {"driver": spec["driver"], "nodeName": spec["nodeName"],
                    "pool": spec["pool"],
                    "devices": [{"name": d["name"], **{
                        k: d["attributes"][k] for k in (
                            "uuid", "coordX", "coordY", "coordZ",
                            "workerIndex")}} for d in spec["devices"]]}
        ref = self.ref_cluster.list(REF_SLICES)
        port = self.port_cluster.list(RESOURCESLICES)
        return ([to_port(shared(s)) for s in ref],
                [shared(s) for s in port])

    def device_names(self):
        ref, port = self.slices()
        return ([d["name"] for s in ref for d in s["devices"]],
                [d["name"] for s in port for d in s["devices"]])

    def claim_env(self, uid):
        def env(cdi):
            import json
            with open(cdi.claim_spec_path(uid)) as f:
                spec = json.load(f)
            return dict(e.split("=", 1) for e in
                        spec["devices"][0]["containerEdits"]["env"])
        return to_port(env(self.ref_cdi)), env(self.port_cdi)


@pytest.fixture(params=["grpc", "framed"])
def transport(request):
    return request.param


@pytest.fixture
def node(tmp_path, transport):
    n = Node(tmp_path, transport)
    yield n
    n.close()


def wait_until(predicate, timeout=10.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


class TestPublishAndRegister:
    def test_published_slice(self, node):
        ref, port = node.slices()
        assert port == ref
        assert len(port) == 1
        assert [d["name"] for d in port[0]["devices"]] == [
            f"gpu-{i}" for i in range(8)]
        slice_name = node.port_cluster.list(RESOURCESLICES)[0]["metadata"]
        assert slice_name["name"] == "node-a-gpu.dev"

    def test_registration_answers_like_the_reference(self, node):
        """As kubelet's plugin watcher, over gRPC: GetInfo names the
        driver and its DRA socket, and a registration status reaches the
        plugin."""
        ref_sock = node.ref.server.registration_socket
        port_sock = node.port.server.registration_socket
        assert port_sock.endswith("gpu.dev-reg.sock")
        import grpc
        channel = grpc.insecure_channel(f"unix://{ref_sock}")
        try:
            ref_info = channel.unary_unary(
                "/pluginregistration.Registration/GetInfo",
                request_serializer=reg.InfoRequest.SerializeToString,
                response_deserializer=reg.PluginInfo.FromString)(
                    reg.InfoRequest(), timeout=TIMEOUT_S)
        finally:
            channel.close()
        channel, get_info, notify = port_server.registration_stubs(port_sock)
        try:
            info = get_info(wire.InfoRequest(), timeout=TIMEOUT_S)
            notify(wire.RegistrationStatus(plugin_registered=True),
                   timeout=TIMEOUT_S)
        finally:
            channel.close()
        assert (info.type, info.supported_versions) == (
            ref_info.type, list(ref_info.supported_versions))
        assert info.name == port_types.GPU_DRIVER_NAME
        assert info.endpoint == node.port.server.dra_socket
        assert node.port.server.registration_registered.wait(TIMEOUT_S)
        assert port_server.self_probe(node.port.server, timeout=TIMEOUT_S)
        assert ref_server.self_probe(node.ref.server, timeout=TIMEOUT_S)

    def test_registration_gated_on_first_publish(self, tmp_path, transport):
        """The first publish fails twice: no registration socket until it
        lands through the retry queue, then both plugins register."""
        def failing(n):
            left = [n]

            def reactor(verb, gvr, obj):
                if gvr.plural == "resourceslices" and left[0] > 0:
                    left[0] -= 1
                    raise OSError("apiserver unavailable")
            return reactor

        n = Node(tmp_path, transport, publish_wait=0,
                 ref_reactors=[failing(2)], port_reactors=[failing(2)])
        try:
            for driver in (n.ref, n.port):
                assert not driver.first_published.is_set()
                assert getattr(driver.server, "registration_socket",
                               None) is None
            for driver in (n.ref, n.port):
                assert driver.first_published.wait(TIMEOUT_S)
                assert wait_until(
                    lambda: driver.server.registration_socket is not None)
            ref, port = n.slices()
            assert port == ref and len(port) == 1
        finally:
            n.close()


class TestPrepare:
    @pytest.mark.parametrize("gpus", [[3], list(range(8))],
                             ids=["one-gpu", "eight-gpus"])
    def test_prepare_and_unprepare(self, node, gpus):
        claim = node.create("u1", gpus)
        ref, port = node.prepare(("u1", claim["metadata"]["name"]))
        assert port == ref
        entry = port["claims"]["u1"]
        assert entry["error"] == "" and len(entry["devices"]) == len(gpus)
        assert entry["devices"][0]["cdi_device_ids"][-1] \
            == "k8s.gpu.dev/claim=u1"
        assert node.records()[1] == node.records()[0]
        ref_env, port_env = node.claim_env("u1")
        assert split_env(port_env)[0] == split_env(ref_env)[0]
        assert set(split_env(port_env)[1]) == set(PORT_ONLY)
        assert set(split_env(ref_env)[1]) <= set(REFERENCE_ONLY)
        ref, port = node.unprepare(("u1", claim["metadata"]["name"]))
        assert port == ref == {"claims": {"u1": {"error": ""}}}
        assert node.records() == ({}, {})
        assert not node.port_cdi.claim_spec_exists("u1")

    def test_404_and_uid_mismatch_isolated_in_a_batch(self, node):
        node.create("good-1", [0])
        node.create("good-2", [1])
        node.create("real-uid", [2], name="mismatched")
        ref, port = node.prepare(("good-1", "c-good-1"),
                                 ("missing", "not-there"),
                                 ("wrong-uid", "mismatched"),
                                 ("good-2", "c-good-2"))
        assert port == ref
        got = port["claims"]
        assert got["good-1"]["error"] == got["good-2"]["error"] == ""
        assert "not found" in got["missing"]["error"]
        assert "UID mismatch" in got["wrong-uid"]["error"]
        assert got["missing"]["devices"] == got["wrong-uid"]["devices"] == []
        assert sorted(node.records()[1]) == ["good-1", "good-2"]
        assert node.records()[1] == node.records()[0]

    def test_same_claim_concurrent_prepares_agree(self, node):
        """Four RPCs for one claim on four connections: the pipeline
        orders them, each answers the same devices, one record."""
        node.create("u1", [2, 3])
        answers = []

        def client(_):
            stubs = node._stubs(port_server, node.port)
            answers.append(stubs[0](wire.NodePrepareResourcesRequest(
                claims=[wire.Claim(namespace="default", uid="u1",
                                   name="c-u1")])).to_dict())

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        ref, _ = node.prepare(("u1", "c-u1"))
        assert len(answers) == 4 and all(a == ref for a in answers)
        assert list(node.records()[1]) == ["u1"]

    def test_time_slicing_config(self, tmp_path, transport):
        ref_gates.Features.set_from_string("TimeSlicingSettings=true")
        port_gates.Features.set_from_string("TimeSlicingSettings=true")
        n = None
        try:
            n = Node(tmp_path, transport, ts=True)
            claim = n.create("u1", [4], configs=[{
                "apiVersion": ref_types.API_VERSION, "kind": "TpuConfig",
                "sharing": {"strategy": "TimeSlicing",
                            "timeSlicingConfig": {"interval": "Long"}}}])
            ref, port = n.prepare(("u1", claim["metadata"]["name"]))
            assert port == ref
            assert port["claims"]["u1"]["error"] == ""
            assert n.records()[1] == n.records()[0]
            assert n.port_backend.timeslices[4] != 0
            n.unprepare(("u1", claim["metadata"]["name"]))
            assert n.port_backend.timeslices[4] == 0
        finally:
            if n is not None:
                n.close()
            ref_gates.Features.reset()


@pytest.mark.parametrize("cls", [RefPipeline, RpcPipeline],
                         ids=["reference", "port"])
def test_pipeline_orders_rpcs_sharing_a_claim(cls):
    """Per-claim-set ordering: an RPC on a claim waits for the earlier
    RPC on it; a disjoint one does not; a drained pipeline refuses."""
    p = cls(window=4, timeout_s=5.0)
    first = p.admit(["a", "b"])
    second = p.admit(["b"])
    disjoint = p.admit(["c"])
    assert second.predecessors == [first.gate]
    assert disjoint.predecessors == []
    p.order(disjoint)
    done = threading.Event()

    def wait_second():
        p.order(second)
        done.set()

    t = threading.Thread(target=wait_second)
    t.start()
    assert not done.wait(0.2)
    p.done(first)
    assert done.wait(5.0)
    t.join(5.0)
    p.done(second)
    p.done(disjoint)
    assert p.drain(timeout_s=1.0) < 1.0
    with pytest.raises(RuntimeError, match="draining"):
        p.admit(["a"])


class TestHealth:
    def test_event_yanks_then_flaps_quarantine_and_clear_readmits(
            self, tmp_path, transport):
        n = Node(tmp_path, transport, quarantine_threshold=2)
        try:
            def same_names(want):
                return wait_until(lambda: n.device_names() == (want, want))

            everything = [f"gpu-{i}" for i in range(8)]
            without5 = [d for d in everything if d != "gpu-5"]
            # A critical XID yanks the GPU; a benign one does not.
            n.ref_backend.inject_health_event(RefEvent(5, 79, "xid"))
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(5, "xid", 79))
            assert same_names(without5)
            # Recovery re-admits; the second fault quarantines.
            n.ref_backend.inject_health_event(RefEvent(5, 0, "recovered"))
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(5, "recovered", 0))
            assert same_names(everything)
            n.ref_backend.inject_health_event(RefEvent(5, 79, "xid"))
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(5, "xid", 79))
            assert same_names(without5)
            assert wait_until(lambda: n.port_state.quarantined_gpus())
            assert list(n.port_state.quarantined_gpus()) == [
                n.gpus[5].uuid] == list(n.ref_state.quarantined_chips())
            # A recovery no longer re-admits a quarantined GPU.
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(5, "recovered", 0))
            n.ref_backend.inject_health_event(RefEvent(5, 0, "recovered"))
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(1, "xid", 13))   # skipped: benign
            n.ref_backend.inject_health_event(RefEvent(1, 13, "xid"))
            assert wait_until(lambda: n.port_backend._events.empty()
                              and n.ref_backend._events.empty())
            import time
            time.sleep(0.3)   # the monitors handled both events
            assert n.device_names() == (without5, without5)
            assert n.port.clear_quarantine(5) == to_port(
                n.ref.clear_quarantine(5)) == ["gpu-5"]
            assert same_names(everything)
            ref, port = n.slices()
            assert port == ref
        finally:
            n.close()

    def test_board_level_event_yanks_every_gpu(self, tmp_path, transport):
        n = Node(tmp_path, transport)
        try:
            n.ref_backend.inject_health_event(RefEvent(-1, 79, "xid"))
            n.port_backend.inject_health_event(
                gpuinfo.HealthEvent(-1, "xid", 79))
            assert wait_until(lambda: n.device_names() == ([], []))
        finally:
            n.close()

    def test_monitor_gate_default_on_and_extra_codes_skipped(self, tmp_path):
        from tpu_dra_torch.gpuplugin.health import (
            DEFAULT_SKIPPED_CODES, DeviceHealthMonitor,
        )
        from tpu_dra.tpuplugin.health import (
            DEFAULT_SKIPPED_CODES as REF_SKIPPED,
        )
        assert DEFAULT_SKIPPED_CODES == REF_SKIPPED
        backend = gpuinfo.FakeBackend()
        seen = []
        mon = DeviceHealthMonitor(backend, seen.append,
                                  additional_codes_to_ignore=[94])
        mon.start()
        try:
            for code in (94, 13, 79):
                backend.inject_health_event(
                    gpuinfo.HealthEvent(2, "xid", code))
            assert wait_until(lambda: len(seen) == 1)
        finally:
            mon.stop()
        assert [e.code for e in seen] == [79]
        assert not mon.wedged
