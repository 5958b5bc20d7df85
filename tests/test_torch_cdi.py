"""Port parity: tpu_dra_torch.cdi.handler (GPU CDI specs) against
tpu_dra.cdi.handler (TPU CDI specs), on the CPU.

Both handlers get the same node: the port's fake 8-GPU HGX H100
inventory, and reference chips with the same indices, UUIDs, PCI
addresses, coordinates and declared topology. Their specs and claim env
are compared EXACTLY after the name map below (NAME_MAP, applied to the
reference's JSON). What one side has and the other has not is stated in
REFERENCE_ONLY / PORT_ONLY and checked on its own. This file holds the
map for every test_torch_* file of the device plane.
"""

import json
import os

import pytest
import torch

from tpu_dra.cdi import handler as ref_handler
from tpu_dra.infra.faults import FAULTS as REF_FAULTS
from tpu_dra.infra.faults import Always as RefAlways
from tpu_dra.infra.faults import FaultInjected as RefFaultInjected
from tpu_dra.native.tpuinfo import Chip
from tpu_dra_torch.cdi import handler as port_handler
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.infra.faults import Always as PortAlways
from tpu_dra_torch.infra.faults import FaultInjected as PortFaultInjected
from tpu_dra_torch.native import gpuinfo

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

# Reference name -> port name, applied in order to the reference's JSON.
NAME_MAP = (
    ("k8s.tpu.dev-chip.json", "k8s.gpu.dev-gpu.json"),  # standard spec file
    ("k8s.tpu.dev/chip", "k8s.gpu.dev/gpu"),   # standard spec kind, CDI ids
    ("k8s.tpu.dev", "k8s.gpu.dev"),            # CDI vendor (claim class)
    ("resource.tpu.dev/v1beta1", "resource.gpu.dev/v1beta1"),  # API group
    ('"driver": "tpu.dev"', '"driver": "gpu.dev"'),  # DRA driver name
    ("TpuConfig", "GpuConfig"),                # opaque config kind
    ("TPUDeviceHealthCheck", "NVMLDeviceHealthCheck"),  # health gate
    ("SliceDaemonsWithDNSNames", "DomainDaemonsWithDNSNames"),  # CD gate
    ("/dev/accel", "/dev/nvidia"),             # device node (minor = index)
    ("TPU_CHIP_COORDS", "GPU_COORDS"),
    ("TPU_CHIP_", "GPU_"),                     # TPU_CHIP_<i>_UUID
    ("TPU_VISIBLE_CHIPS", "GPU_VISIBLE_INDICES"),
    ("TPU_SLICE_TOPOLOGY", "GPU_FABRIC_TOPOLOGY"),
    ("TPU_GENERATION", "GPU_GENERATION"),
    ("TPU_SLICE_ID", "GPU_CLIQUE_ID"),
    ("TPU_WORKER_INDEX", "GPU_WORKER_INDEX"),
    ("TPU_SHARING_STRATEGY", "GPU_SHARING_STRATEGY"),
    ("TPU_PASSTHROUGH", "GPU_PASSTHROUGH"),
    ("chip_index", "gpu_index"),               # checkpoint record keys
    ("chip_uuid", "gpu_uuid"),
    ('"chip"', '"gpu"'),                       # device type
    ("chip-", "gpu-"),                         # device names
)
# Env the reference sets with no GPU counterpart: libtpu's process bounds
# and its metadata-server switch.
REFERENCE_ONLY = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "TPU_PROCESS_BOUNDS",
                  "TPU_SKIP_MDS_QUERY")
# Env the port adds: the GPUs' UUIDs for CUDA and the container toolkit.
PORT_ONLY = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")
# Same name on both sides, a value per claim trace: compared for presence.
TRACE_KEY = "TPU_DRA_TRACEPARENT"


def to_port(obj):
    """The reference's object with its names mapped to the port's. A CDI
    "env" list is sorted by name, as both handlers write it, so it is
    sorted again after the renaming."""
    text = json.dumps(obj, sort_keys=True)
    for ref, port in NAME_MAP:
        text = text.replace(ref, port)
    return _sort_env_lists(json.loads(text))


def _sort_env_lists(obj):
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "env" and isinstance(v, list)
                    else _sort_env_lists(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sort_env_lists(v) for v in obj]
    return obj


def reference_chips(gpus):
    """Reference chips standing for `gpus`: the same index, UUID, PCI
    address, coordinates, declared topology and generation."""
    return [Chip(index=g.index, uuid=g.uuid, generation=g.generation,
                 tensorcore_count=1, hbm_bytes=g.memory_bytes,
                 pci_address=g.pci_bus_id, slice_id=g.clique_id,
                 worker_index=g.worker_index, coords=g.coords,
                 slice_topology=g.slice_topology) for g in gpus]


def split_env(env):
    """(shared, reference-or-port-only, trace) parts of one side's env."""
    own = {k: v for k, v in env.items()
           if k in REFERENCE_ONLY or k in PORT_ONLY}
    shared = {k: v for k, v in env.items()
              if k not in own and k != TRACE_KEY}
    return shared, own, env.get(TRACE_KEY)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


@pytest.fixture
def node(tmp_path):
    gpus = gpuinfo.default_fake_gpus(8)
    ref = ref_handler.CDIHandler(str(tmp_path / "ref"),
                                 driver_root=str(tmp_path / "drv"))
    port = port_handler.CDIHandler(str(tmp_path / "port"),
                                   driver_root=str(tmp_path / "drv"))
    return {"gpus": gpus, "chips": reference_chips(gpus), "ref": ref,
            "port": port, "tmp": tmp_path}


class TestStandardSpec:
    def test_devices_match_reference(self, node):
        ref = node["ref"].read_spec(
            node["ref"].create_standard_device_spec_file(node["chips"]))
        port = node["port"].read_spec(
            node["port"].create_standard_device_spec_file(node["gpus"]))
        mapped = to_port(ref)
        assert port["devices"] == mapped["devices"]
        assert port["kind"] == mapped["kind"] == "k8s.gpu.dev/gpu"
        assert port["cdiVersion"] == mapped["cdiVersion"]
        assert port["devices"][3]["containerEdits"]["deviceNodes"] == [
            {"path": "/dev/nvidia3", "hostPath": "/dev/nvidia3"}]

    def test_spec_wide_edits(self, node):
        ref = node["ref"].read_spec(
            node["ref"].create_standard_device_spec_file(node["chips"]))
        port = node["port"].read_spec(
            node["port"].create_standard_device_spec_file(node["gpus"]))
        # Reference only: its metadata-server switch.
        assert ref["containerEdits"] == {"env": ["TPU_SKIP_MDS_QUERY=true"]}
        # Port only: the control nodes every CUDA process opens; no
        # driver library under an empty driver root.
        assert port["containerEdits"] == {"deviceNodes": [
            {"path": p, "hostPath": p}
            for p in ("/dev/nvidiactl", "/dev/nvidia-uvm",
                      "/dev/nvidia-uvm-tools")]}

    def test_driver_libraries_mounted_from_driver_root(self, tmp_path):
        root = tmp_path / "host"
        lib_dir = root / "usr" / "lib" / "x86_64-linux-gnu"
        lib_dir.mkdir(parents=True)
        for name in ("libcuda.so.1", "libnvidia-ml.so.1"):
            (lib_dir / name).write_text("")
        cdi = port_handler.CDIHandler(str(tmp_path / "cdi"),
                                      driver_root=str(root),
                                      dev_root=str(root))
        spec = cdi.read_spec(cdi.create_standard_device_spec_file(
            gpuinfo.default_fake_gpus(1)))
        assert spec["containerEdits"]["mounts"] == [
            {"hostPath": str(lib_dir / name),
             "containerPath": f"/usr/lib/x86_64-linux-gnu/{name}",
             "options": ["ro", "nosuid", "nodev", "bind"]}
            for name in ("libcuda.so.1", "libnvidia-ml.so.1")]
        node = spec["devices"][0]["containerEdits"]["deviceNodes"][0]
        assert node == {"path": "/dev/nvidia0",
                        "hostPath": str(root / "dev" / "nvidia0")}

    def test_spec_file_name_matches_reference(self, node):
        ref = node["ref"].create_standard_device_spec_file(node["chips"])
        port = node["port"].create_standard_device_spec_file(node["gpus"])
        assert os.path.basename(port) == to_port(os.path.basename(ref))
        assert not os.path.exists(port + ".tmp")


CLAIM_ENVS = [
    {},
    {"TPU_VISIBLE_CHIPS": "0", "TPU_CHIP_COORDS": "0:0.0.0"},
    {"TPU_VISIBLE_CHIPS": "2,3", "TPU_SHARING_STRATEGY": "time-slicing",
     "TPU_SLICE_TOPOLOGY": "8x1x1", "TPU_GENERATION": "hopper"},
    {"TPU_VISIBLE_CHIPS": "7", "NAME": "value with \"quotes\" and \\"},
]


class TestClaimSpec:
    @pytest.mark.parametrize("env", CLAIM_ENVS)
    def test_claim_spec_matches_reference(self, node, env):
        ref_path, ref_text = node["ref"].serialize_claim_spec("uid-1", env)
        port_path, port_text = node["port"].serialize_claim_spec(
            "uid-1", to_port(env))
        assert to_port(json.loads(ref_text)) == json.loads(port_text)
        assert os.path.basename(port_path) == to_port(
            os.path.basename(ref_path))

    @pytest.mark.parametrize("env", CLAIM_ENVS)
    @pytest.mark.parametrize("shape", ["plain", "mounts", "nodes", "both"])
    def test_cached_render_is_byte_identical(self, node, env, shape):
        mounts = ([{"hostPath": "/h", "containerPath": "/c",
                    "options": ["ro"]}] if shape in ("mounts", "both")
                  else None)
        nodes = ([{"path": "/dev/nvidia-caps/x"}]
                 if shape in ("nodes", "both") else None)
        cdi = node["port"]
        env = to_port(env)
        for uid in ("u-a", "u-b", "u-a"):   # miss, then cache hits
            _, text = cdi.serialize_claim_spec(uid, env, mounts=mounts,
                                               device_nodes=nodes)
            assert text == cdi._serialize_claim_spec_direct(
                uid, env, mounts, nodes)

    def test_write_list_delete_match_reference(self, node):
        for side, env in (("ref", {"TPU_VISIBLE_CHIPS": "1"}),
                          ("port", {"GPU_VISIBLE_INDICES": "1"})):
            cdi = node[side]
            for uid in ("a", "b"):
                cdi.create_claim_spec_file(uid, env)
            assert sorted(cdi.list_claim_uids()) == ["a", "b"]
            assert cdi.claim_spec_exists("a")
            cdi.delete_claim_spec_file("a")
            cdi.delete_claim_spec_file("a")   # idempotent
            assert cdi.list_claim_uids() == ["b"]
            assert not cdi.claim_spec_exists("a")
        ref_b = node["ref"].read_spec(node["ref"].claim_spec_path("b"))
        port_b = node["port"].read_spec(node["port"].claim_spec_path("b"))
        assert to_port(ref_b) == port_b

    def test_claim_write_fault_site_fires_on_both(self, node):
        with REF_FAULTS.armed("cdi.claim_write", RefAlways()):
            with pytest.raises(RefFaultInjected):
                node["ref"].serialize_claim_spec("u", {})
        with PORT_FAULTS.armed("cdi.claim_write", PortAlways()):
            with pytest.raises(PortFaultInjected):
                node["port"].serialize_claim_spec("u", {})


class TestVisibleEnv:
    @pytest.mark.parametrize("indices", [[0], [3, 1], list(range(8))])
    def test_visible_env_against_reference(self, node, indices):
        ref = ref_handler.visible_chips_env(indices)
        port = port_handler.visible_gpus_env(
            [node["gpus"][i] for i in indices])
        ref_shared, ref_own, _ = split_env(to_port(ref))
        port_shared, port_own, _ = split_env(port)
        assert port_shared == ref_shared
        assert set(ref_own) == {"TPU_CHIPS_PER_PROCESS_BOUNDS",
                                "TPU_PROCESS_BOUNDS"}
        uuids = ",".join(node["gpus"][i].uuid for i in sorted(indices))
        assert port_own == {"CUDA_VISIBLE_DEVICES": uuids,
                            "NVIDIA_VISIBLE_DEVICES": uuids}


class TestContainerEdits:
    def test_runtime_view_of_a_prepared_claim(self, node):
        """What a runtime applies for a claim's CDI ids: the standard
        spec's per-GPU and spec-wide edits plus the claim spec's env."""
        cdi = node["port"]
        cdi.create_standard_device_spec_file(node["gpus"])
        env = port_handler.visible_gpus_env(node["gpus"][2:4])
        cdi.create_claim_spec_file("uid-9", env)
        ids = [cdi.get_standard_device(node["gpus"][2].uuid),
               cdi.get_claim_device("uid-9"),
               cdi.get_standard_device(node["gpus"][3].uuid)]
        edits = cdi.container_edits(ids)
        assert edits["env"] == {
            **env, "GPU_2_UUID": node["gpus"][2].uuid,
            "GPU_3_UUID": node["gpus"][3].uuid}
        assert [n["path"] for n in edits["deviceNodes"]] == [
            "/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools",
            "/dev/nvidia2", "/dev/nvidia3"]
        assert edits["mounts"] == []

    def test_unknown_device_refused(self, node):
        cdi = node["port"]
        cdi.create_standard_device_spec_file(node["gpus"][:1])
        with pytest.raises(KeyError, match="not in"):
            cdi.container_edits([cdi.get_standard_device("GPU-nope")])
