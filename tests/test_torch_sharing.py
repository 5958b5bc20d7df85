"""Port parity: MPS sharing (tpu_dra_torch.gpuplugin.sharing's
MpsControlDaemon and MpsManager, tpu_dra_torch.testing's MpsNodeSim)
against the reference's multiprocess sharing (tpu_dra.tpuplugin.sharing's
MultiprocessDaemon and MultiprocessManager), on the CPU.

The reference's daemon is a tpu-multiprocess-coordinator Deployment; the
port's runs ``nvidia-cuda-mps-control -f``. Their Deployments are held
equal after DEPLOYMENT_MAP (labels, selector, volumes, probes' timing,
replica count, node), and the reference's coordinator arguments against
the port's CUDA_MPS_* env (the limits the daemon reads). The limits
normalization is held against the reference's ``_limits()`` on the same
UUID, index and "default" maps.

Through DeviceState, a FakeCluster and MpsNodeSim playing kubelet with
the stand-in control daemon (tpu_dra_torch.testing.MPS_STANDIN, which
honours the real one's foreground, pipe and probe contract): prepare ->
ready -> edits -> unprepare, the ready timeout, the daemon's death
mid-claim, exclusive compute mode set and cleared, a compute mode the
GPU refuses, and the restarts that stop a leaked Deployment (the
counterparts of test_multiprocess_e2e.py's TestRealCoordinatorLifecycle).
"""

import json
import os
import subprocess

import pytest
import torch

from tpu_dra.api import types as ref_types
from tpu_dra.k8s import DEPLOYMENTS as REF_DEPLOYMENTS
from tpu_dra.k8s import FakeCluster as RefCluster
from tpu_dra.tpuplugin.sharing import MultiprocessDaemon
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.gpuplugin import sharing
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.k8s import DEPLOYMENTS, FakeCluster
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.testing import MPS_STANDIN, MpsNodeSim

from test_torch_cdi import reference_chips
from test_torch_mig import _Crash, claim, crash_at_terminal_commit

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

NAMESPACE = "gpu-dra"
# Reference name -> port name, applied to the reference's Deployment JSON.
DEPLOYMENT_MAP = (
    ("tpu-multiprocess-daemon", sharing.MPS_APP_LABEL),
    ("tpu-multiprocess-", "gpu-mps-"),          # Deployment name prefix
    ("tpu.dev/", "gpu.dev/"),
    ('"coordinator"', '"mps-control-daemon"'),  # container name
    ('"coord"', '"mps"'),                       # volume name
    ("/multiprocess", sharing.MPS_CONTAINER_DIR),
)
# What the port's Deployment has and the reference's has not: the preStop
# hook that stops the MPS server ("quit"), and the env of the limits
# (the reference passes them as coordinator arguments).
PORT_ONLY_CONTAINER = ("lifecycle",)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


def gpus(n=4):
    return gpuinfo.default_fake_gpus(n)


def ref_deployment(uid, chips, config, root):
    cluster = RefCluster()
    MultiprocessDaemon(uid, chips, config, node_name="node-a",
                       namespace=NAMESPACE, root_dir=root, client=cluster,
                       image="img").start()
    (dep,) = cluster.list(REF_DEPLOYMENTS, NAMESPACE)
    text = json.dumps(dep)
    for ref, port in DEPLOYMENT_MAP:
        text = text.replace(ref, port)
    return json.loads(text)


def port_daemon(uid, g, config, root, client=None):
    return sharing.MpsControlDaemon(
        uid, g, config, node_name="node-a", namespace=NAMESPACE,
        root_dir=root, client=client or FakeCluster(), image="img")


class TestDaemon:
    def test_deployment_against_reference(self, tmp_path):
        g = gpus()[1:3]
        uid = "0123456789abcdef-claim"
        ref = ref_deployment(uid, reference_chips(g),
                             ref_types.MultiprocessConfig(
                                 default_active_cores_percentage=50,
                                 default_hbm_limit="8Gi"),
                             str(tmp_path))
        port = port_daemon(uid, g, port_types.MpsConfig(
            default_active_thread_percentage=50,
            default_pinned_device_memory_limit="8Gi"),
            str(tmp_path)).deployment()
        assert port["metadata"]["name"] == ref["metadata"]["name"] \
            == "gpu-mps-0123456789abc"
        assert port["metadata"]["labels"] == ref["metadata"]["labels"]
        assert port["spec"]["replicas"] == ref["spec"]["replicas"] == 1
        assert port["spec"]["selector"] == ref["spec"]["selector"]
        rpod, ppod = (d["spec"]["template"] for d in (ref, port))
        assert ppod["metadata"] == rpod["metadata"]
        assert ppod["spec"]["nodeName"] == rpod["spec"]["nodeName"]
        assert ppod["spec"]["volumes"] == rpod["spec"]["volumes"]
        (rc,), (pc,) = rpod["spec"]["containers"], ppod["spec"]["containers"]
        assert set(pc) - set(rc) == set(PORT_ONLY_CONTAINER)
        for key in ("name", "image", "volumeMounts"):
            assert pc[key] == rc[key], key
        for probe in ("startupProbe", "readinessProbe"):
            assert {k: v for k, v in pc[probe].items() if k != "exec"} \
                == {k: v for k, v in rc[probe].items() if k != "exec"}
            assert pc[probe]["exec"]["command"] == [
                "sh", "-c", "echo get_server_list | nvidia-cuda-mps-control"]
        # The coordinator's arguments against the daemon's env.
        assert pc["command"] == ["nvidia-cuda-mps-control", "-f"]
        args = rc["command"]
        env = {e["name"]: e["value"] for e in pc["env"]}
        assert env["CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"] \
            == args[args.index("--tensorcore-pct") + 1] == "50"
        hbm = dict(kv.split("=") for kv in
                   args[args.index("--hbm-limit-map") + 1].split(","))
        assert env["CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"] == ",".join(
            f"{i}={int(hbm[x.uuid]) >> 20}M" for i, x in enumerate(g))
        assert env["CUDA_VISIBLE_DEVICES"] == ",".join(x.uuid for x in g)
        assert env["CUDA_MPS_PIPE_DIRECTORY"] == "/mps/pipe"
        assert env["CUDA_MPS_LOG_DIRECTORY"] == "/mps/log"
        assert rpod["spec"]["containers"][0]["env"][1] == {
            "name": "TPU_MULTIPROCESS_DIR", "value": "/mps"}

    @pytest.mark.parametrize("limits,default", [
        ({}, None), ({}, "4Gi"), ({"default": "2Gi"}, "4Gi"),
        ({"2": "1Gi"}, "4Gi"), ({"uuid1": "512Mi", "default": "3Gi"}, None),
        ({"1": "1Gi", "2": "2Gi"}, None),
    ], ids=["none", "config-default", "map-default", "index-key",
            "uuid-key", "only-indices"])
    def test_limits_against_reference(self, tmp_path, limits, default):
        g = gpus()[1:3]
        keyed = {(g[0].uuid if k == "uuid1" else k): v
                 for k, v in limits.items()}
        ref = MultiprocessDaemon(
            "u", reference_chips(g), ref_types.MultiprocessConfig(
                default_hbm_limit=default,
                per_device_hbm_limit=(ref_types.MultiprocessPerDeviceHbmLimit(
                    dict(keyed)) if keyed else None)),
            node_name="n", namespace=NAMESPACE, root_dir=str(tmp_path),
            client=RefCluster(), image="i")._limits()
        port = port_daemon("u", g, port_types.MpsConfig(
            default_pinned_device_memory_limit=default,
            per_device_pinned_memory_limit=(
                port_types.MpsPerDevicePinnedMemoryLimit(dict(keyed))
                if keyed else None)), str(tmp_path)).limits()
        assert port == ref

    def test_limit_for_a_foreign_gpu_refused_as_reference(self, tmp_path):
        g = gpus()[1:2]
        with pytest.raises(ref_types.ValidationError, match="not part"):
            MultiprocessDaemon(
                "u", reference_chips(g), ref_types.MultiprocessConfig(
                    per_device_hbm_limit=ref_types
                    .MultiprocessPerDeviceHbmLimit({"5": "1Gi"})),
                node_name="n", namespace=NAMESPACE, root_dir=str(tmp_path),
                client=RefCluster(), image="i")._limits()
        with pytest.raises(port_types.ValidationError, match="not part"):
            port_daemon("u", g, port_types.MpsConfig(
                per_device_pinned_memory_limit=port_types
                .MpsPerDevicePinnedMemoryLimit({"5": "1Gi"})),
                str(tmp_path)).limits()

    def test_cdi_edits_keys(self, tmp_path):
        g = gpus()[2:3]
        edits = port_daemon("u1", g, port_types.MpsConfig(
            default_active_thread_percentage=25,
            default_pinned_device_memory_limit="1536Mi"),
            str(tmp_path)).cdi_edits()
        assert edits["env"] == {
            "CUDA_MPS_PIPE_DIRECTORY": "/mps/pipe",
            "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE": "25",
            "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT": "0=1536M"}
        ref = MultiprocessDaemon(
            "u1", reference_chips(g), ref_types.MultiprocessConfig(),
            node_name="n", namespace=NAMESPACE, root_dir=str(tmp_path),
            client=RefCluster(), image="i").cdi_edits()
        (pm,), (rm,) = edits["mounts"], ref["mounts"]
        assert pm == {**rm, "containerPath": "/mps"}
        assert pm["hostPath"] == str(tmp_path / "u1")


MPS_CONFIG = {"apiVersion": port_types.API_VERSION, "kind": "GpuConfig",
              "sharing": {"strategy": "MPS", "mpsConfig": {
                  "defaultActiveThreadPercentage": 50,
                  "defaultPinnedDeviceMemoryLimit": "8Gi"}}}


class RefusingBackend(gpuinfo.FakeBackend):
    """A GPU whose compute mode cannot be set, as NVML answers on a
    virtualised host."""

    def set_exclusive_mode(self, index, exclusive):
        raise gpuinfo.NvmlError(
            f"nvmlDeviceSetComputeMode({index}, 3)",
            gpuinfo.NVML_ERROR_NOT_SUPPORTED, "Not Supported")


class Node:
    """A port DeviceState with an MpsManager over a FakeCluster; `sim`
    plays kubelet with the stand-in daemon unless False."""

    def __init__(self, tmp, sim=True, backend=None, ready_timeout=20.0):
        port_gates.Features.set_from_string("MultiprocessSupport=true")
        self.tmp = tmp
        self.cluster = FakeCluster()
        self.backend = backend or gpuinfo.FakeBackend(gpus())
        self.cdi = CDIHandler(str(tmp / "cdi"), driver_root=str(tmp / "drv"))
        self.root = str(tmp / "mps")
        self.ready_timeout = ready_timeout
        self.sim = (MpsNodeSim(self.cluster, NAMESPACE, binary=MPS_STANDIN,
                               interval=0.02).start() if sim else None)
        self.start()

    def start(self):
        self.ckpt = CheckpointManager(str(self.tmp / "plugin"))
        self.manager = sharing.MpsManager(
            self.backend, self.cluster, node_name="node-a",
            namespace=NAMESPACE, root_dir=self.root,
            ready_timeout=self.ready_timeout)
        self.state = DeviceState(
            backend=self.backend, cdi=self.cdi, checkpoints=self.ckpt,
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a",
            mps_manager=self.manager)

    def close(self):
        self.state.close()
        if self.sim is not None:
            self.sim.stop()

    def deployments(self):
        return self.cluster.list(DEPLOYMENTS, NAMESPACE)

    def edits(self, uid):
        res = self.state.prepare_batch([claim(uid, ["gpu-2"],
                                              [MPS_CONFIG])])[uid]
        assert res.error == "", res.error
        return self.cdi.container_edits(res.devices[0].cdi_device_ids)

    def clean(self, uid):
        return (self.deployments() == []
                and uid not in self.state.prepared_claim_uids()
                and uid not in self.cdi.list_claim_uids()
                and not os.path.exists(os.path.join(self.root, uid)))


@pytest.fixture
def mps_node(tmp_path):
    n = Node(tmp_path)
    yield n
    n.close()


def control(env, command):
    return subprocess.run(MPS_STANDIN, input=command + "\n", env={
        **os.environ, **env}, capture_output=True, text=True, timeout=30)


class TestLifecycle:
    def test_prepare_ready_edits_unprepare(self, mps_node):
        n = mps_node
        edits = n.edits("u1")
        (dep,) = n.deployments()
        assert dep["status"]["readyReplicas"] == 1
        proc = n.sim.processes[dep["metadata"]["name"]]
        assert proc.poll() is None
        assert n.backend.exclusive == {2: True}
        env = edits["env"]
        assert env["GPU_SHARING_STRATEGY"] == "mps"
        assert env["CUDA_MPS_PIPE_DIRECTORY"] == "/mps/pipe"
        assert env["CUDA_VISIBLE_DEVICES"] == n.backend.get_gpu(2).uuid
        (mount,) = edits["mounts"]
        assert mount["containerPath"] == "/mps"
        host_dir = mount["hostPath"]
        assert host_dir == n.sim.host_dir(dep["metadata"]["name"])
        # The daemon read the same limits the tenants get.
        with open(os.path.join(host_dir, "log", "control.log")) as f:
            daemon_env = dict(line.strip().split("=", 1) for line in f)
        for key in ("CUDA_MPS_ACTIVE_THREAD_PERCENTAGE",
                    "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"):
            assert daemon_env[key] == env[key]
        assert env["CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"] == "0=8192M"
        # A tenant reaches the daemon through the claim's pipe directory,
        # as the container runtime mounts it.
        tenant = {"CUDA_MPS_PIPE_DIRECTORY": env[
            "CUDA_MPS_PIPE_DIRECTORY"].replace("/mps", host_dir, 1)}
        assert control(tenant, "get_server_list").returncode == 0
        assert n.state.unprepare("u1") is None
        assert n.clean("u1")
        assert n.cluster.wait_for(lambda: proc.poll() is not None, 10)
        assert n.backend.exclusive == {2: False}
        assert control(tenant, "get_server_list").returncode != 0

    def test_ready_timeout(self, tmp_path):
        n = Node(tmp_path, sim=False, ready_timeout=0.3)
        try:
            res = n.state.prepare(claim("u1", ["gpu-2"], [MPS_CONFIG]))
            assert "not ready within 0.3s" in res.error
            assert n.clean("u1")
            assert n.backend.exclusive == {2: False}
        finally:
            n.close()

    def test_daemon_death_mid_claim_then_unprepare(self, mps_node):
        n = mps_node
        n.edits("u1")
        (dep,) = n.deployments()
        name = dep["metadata"]["name"]
        proc = n.sim.processes[name]
        proc.kill()
        proc.wait()
        assert n.cluster.wait_for(lambda: n.cluster.get(
            DEPLOYMENTS, name, NAMESPACE)["status"]["readyReplicas"] == 0, 10)
        assert n.state.unprepare("u1") is None
        assert n.clean("u1")
        assert n.backend.exclusive == {2: False}

    def test_compute_mode_refused_leaves_nothing(self, tmp_path):
        n = Node(tmp_path, backend=RefusingBackend(gpus()))
        try:
            res = n.state.prepare(claim("u1", ["gpu-2"], [MPS_CONFIG]))
            assert "nvmlDeviceSetComputeMode" in res.error
            assert "Not Supported" in res.error
            assert n.clean("u1") and n.sim.processes == {}
            assert n.backend.compute_mode(2) == \
                gpuinfo.NVML_COMPUTEMODE_DEFAULT
        finally:
            n.close()

    def test_manager_disabled_refused(self, tmp_path):
        port_gates.Features.set_from_string("MultiprocessSupport=true")
        state = DeviceState(
            backend=gpuinfo.FakeBackend(gpus()),
            cdi=CDIHandler(str(tmp_path / "cdi")),
            checkpoints=CheckpointManager(str(tmp_path / "p")),
            driver_name=port_types.GPU_DRIVER_NAME, node_name="node-a")
        try:
            res = state.prepare(claim("u1", ["gpu-2"], [MPS_CONFIG]))
            assert "MPS requested but manager disabled" in res.error
            assert state.prepared_claim_uids() == []
        finally:
            state.close()


class TestRestart:
    def test_crash_after_intent_stops_the_deployment(self, mps_node):
        n = mps_node
        crash_at_terminal_commit(n.ckpt)
        with pytest.raises(_Crash):
            n.state.prepare(claim("u1", ["gpu-2"], [MPS_CONFIG]))
        assert len(n.deployments()) == 1 and n.backend.exclusive[2]
        n.start()
        assert n.clean("u1")
        assert n.backend.exclusive[2] is False

    def test_unheld_deployment_stopped_at_start(self, mps_node):
        n = mps_node
        n.edits("u1")
        g = n.backend.get_gpu(3)
        leaked = port_daemon("u-leaked", [g], port_types.MpsConfig(),
                             n.root, client=n.cluster)
        leaked.start()
        n.backend.set_exclusive_mode(3, True)
        n.state.close()
        n.start()
        (kept,) = n.deployments()
        assert kept["metadata"]["name"] == sharing.mps_deployment_name("u1")
        assert not os.path.exists(leaked.host_dir)
        assert n.backend.exclusive == {2: True, 3: False}
        assert n.state.unprepare("u1") is None and n.clean("u1")



class NoPolicyBackend(RefusingBackend):
    """A GPU that supports neither a time-slice policy nor a settable
    compute mode, as nvidia-smi and NVML answer on a virtualised host."""

    def set_timeslice(self, index, level):
        raise gpuinfo.NvmlError(
            f"nvidia-smi compute-policy --set-timeslice={level} on GPU "
            f"{index}", gpuinfo.NVML_ERROR_NOT_SUPPORTED,
            "Failed to set timeslice policy: Not Supported")


class UntypedRefusalBackend(NoPolicyBackend):
    """A time-slice refusal that carries the words but not the code."""

    def set_timeslice(self, index, level):
        raise RuntimeError(f"set-timeslice={level} on GPU {index}: "
                           "Not Supported")


class UnreadableModeBackend(NoPolicyBackend):
    """A GPU without the policy whose compute mode NVML cannot report."""

    def compute_mode(self, index):
        self.get_gpu(index)
        return None


class TestTimeSliceWithoutPolicy:
    """With TimeSlicingSettings on, a claim's default config normalizes
    to time-slicing at the Default interval: on a GPU without the policy
    that reads compute mode DEFAULT that is the state it is in, so the
    claim prepares; an explicit interval, a refusal without NVML's
    NOT_SUPPORTED code, or a compute mode that cannot be read still fails
    the prepare."""

    def _state(self, tmp_path, backend=None):
        port_gates.Features.set_from_string("TimeSlicingSettings=true")
        backend = backend or NoPolicyBackend()
        return DeviceState(
            backend=backend, cdi=CDIHandler(str(tmp_path / "cdi")),
            checkpoints=CheckpointManager(str(tmp_path / "p")),
            driver_name=port_types.GPU_DRIVER_NAME, node_name="n",
            ts_manager=sharing.TimeSlicingManager(backend))

    def _claim(self, uid, config=None):
        cfg = [] if config is None else [{
            "requests": ["gpu"], "source": "FromClaim", "opaque": {
                "driver": port_types.GPU_DRIVER_NAME,
                "parameters": config}}]
        return {"metadata": {"uid": uid, "name": uid, "namespace": "d"},
                "status": {"allocation": {"devices": {"results": [{
                    "request": "gpu", "driver": port_types.GPU_DRIVER_NAME,
                    "pool": "n", "device": "gpu-0"}], "config": cfg}}}}

    def test_default_claim_prepares(self, tmp_path):
        state = self._state(tmp_path)
        res = state.prepare(self._claim("a"))
        assert not res.error, res.error
        assert state.unprepare("a") is None

    def test_explicit_interval_still_fails(self, tmp_path):
        state = self._state(tmp_path)
        res = state.prepare(self._claim("b", {
            "apiVersion": port_types.API_VERSION, "kind": "GpuConfig",
            "sharing": {"strategy": "TimeSlicing",
                        "timeSlicingConfig": {"interval": "Long"}}}))
        assert "Not Supported" in res.error
        assert state.prepared_claim_uids() == []

    def test_untyped_refusal_fails(self, tmp_path):
        state = self._state(tmp_path, UntypedRefusalBackend())
        res = state.prepare(self._claim("c"))
        assert "Not Supported" in res.error

    def test_unreadable_compute_mode_fails(self, tmp_path):
        state = self._state(tmp_path, UnreadableModeBackend())
        res = state.prepare(self._claim("d"))
        assert "nvmlDeviceSetComputeMode" in res.error


@pytest.mark.parametrize("rc,typed", [(3, True), (1, False)])
def test_smi_set_timeslice_exit_code(tmp_path, rc, typed):
    """nvidia-smi's exit code 3 (operation not available on the device)
    is NVML's NOT_SUPPORTED; any other failure stays untyped."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'Failed to set timeslice' >&2\n"
                   f"exit {rc}\n")
    smi.chmod(0o755)
    with pytest.raises(RuntimeError) as info:
        gpuinfo.smi_set_timeslice(str(smi), 0, 2)
    assert isinstance(info.value, gpuinfo.NvmlError) == typed
    if typed:
        assert info.value.code == gpuinfo.NVML_ERROR_NOT_SUPPORTED
    assert "Failed to set timeslice" in str(info.value)
