"""Port parity: tpu_dra_torch.topology.meshexport (+ mesh, placement) and
tpu_dra_torch.workloads.meshbuild against tpu_dra.topology.meshexport
and tpu_dra.workloads.meshbuild, on the CPU.

The reference's own cases (tests/test_meshbuild.py) run on both sides,
the reference's env mapped to the port's names (test_torch_cdi.NAME_MAP):
the MeshPlan's order (coords, keys, arrival permutation, contiguity) is
compared exactly and every refusal must refuse on both. The NVLink cost
is the one designed difference: on an NVSwitch every ring step is one
hop, where the reference's line charges the closing step n - 1.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_dra.infra.faults import FAULTS as REF_FAULTS
from tpu_dra.infra.faults import Always as RefAlways
from tpu_dra.infra.faults import FaultInjected as RefFaultInjected
from tpu_dra.topology import meshexport as rme
from tpu_dra.workloads import meshbuild as rmb
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.infra.faults import Always as PortAlways
from tpu_dra_torch.infra.faults import FaultInjected as PortFaultInjected
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.topology import meshexport as me
from tpu_dra_torch.topology.mesh import NvlinkFabric
from tpu_dra_torch.workloads import meshbuild as mb

from test_torch_cdi import reference_chips, to_port

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


def plan_order(plan):
    """The fields a plan's rank order is made of, on either side."""
    keys = getattr(plan, "gpu_keys", None) or plan.chip_keys
    dims = getattr(plan, "fabric_dims", None) or plan.slice_dims
    return (plan.coords, keys, plan.order, plan.contiguous, dims,
            plan.n_workers)


def line(n):
    return [(i, 0, 0) for i in range(n)]


def cuboid_coords(dims):
    return [(x, y, z) for z in range(dims[2]) for y in range(dims[1])
            for x in range(dims[0])]


# (coords in arrival order, declared dims): the reference's order cases
# and a node's lines.
ORDER_CASES = [
    (line(8), (8, 1, 1)),
    (line(1), (1, 1, 1)),
    ([(5, 0, 0), (2, 0, 0), (7, 0, 0)], (8, 1, 1)),      # fragmented
    (cuboid_coords((2, 2, 2)), (2, 2, 2)),
    (list(reversed(cuboid_coords((4, 4, 1)))), (4, 4, 1)),
    (cuboid_coords((2, 2, 1)), (4, 4, 4)),
    ([(2, 1, 0), (3, 1, 0)], None),                      # undeclared
]


class TestPlanOrder:
    @pytest.mark.parametrize("coords,dims", ORDER_CASES)
    def test_order_matches_reference(self, coords, dims):
        keyed = {(0, i): c for i, c in enumerate(coords)}
        ref = rme.plan_from_coords(keyed, dims, "v5e")
        port = me.plan_from_coords(keyed, dims, "hopper")
        assert plan_order(port) == plan_order(ref)

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_nvswitch_ring_is_one_hop_per_step(self, n):
        keyed = {(0, i): c for i, c in enumerate(line(n))}
        ref = rme.plan_from_coords(keyed, (n, 1, 1), "v5e")
        port = me.plan_from_coords(keyed, (n, 1, 1), "hopper")
        assert ref.hops == (1,) * (n - 1) + (n - 1,)   # a line's wrap
        assert port.hops == (1,) * n
        assert port.hop_mean == 1.0 and port.hop_max == 1
        # 450 GB/s per direction (the H100 SXM's NVLink 4) over the ring.
        assert port.modeled_nvlink_gbps == pytest.approx(
            450.0 * n / (2 * (n - 1)))

    def test_fragmented_allocation_costs_the_same_on_a_switch(self):
        frag = me.plan_from_coords(
            {(0, 0): (0, 0, 0), (0, 1): (5, 0, 0)}, (8, 1, 1), "hopper")
        contig = me.plan_from_coords(
            {(0, 0): (0, 0, 0), (0, 1): (1, 0, 0)}, (8, 1, 1), "hopper")
        assert not frag.contiguous and contig.contiguous
        assert frag.modeled_nvlink_gbps == contig.modeled_nvlink_gbps

    def test_fabric_distance(self):
        fabric = NvlinkFabric(dims=(8, 1, 1))
        assert fabric.distance((0, 0, 0), (7, 0, 0)) == 1
        assert fabric.distance((3, 0, 0), (3, 0, 0)) == 0
        assert len(fabric.neighbors((2, 0, 0))) == 7

    def test_deterministic_across_permutations(self):
        import random
        coords = line(8)
        base = me.plan_from_coords(
            {(0, i): c for i, c in enumerate(coords)}, (8, 1, 1), "hopper")
        for seed in range(3):
            shuffled = list(coords)
            random.Random(seed).shuffle(shuffled)
            p = me.plan_from_coords(
                {(0, i): c for i, c in enumerate(shuffled)}, (8, 1, 1),
                "hopper")
            assert p.coords == base.coords


class TestExport:
    @pytest.mark.parametrize("indices", [[0], [2, 5], list(range(8))])
    def test_export_matches_reference(self, indices):
        gpus = gpuinfo.default_fake_gpus(8)
        chips = reference_chips(gpus)
        ref = rme.export_topology_env([chips[i] for i in indices])
        port = me.export_topology_env([gpus[i] for i in indices])
        assert port == to_port(ref)
        assert port["GPU_FABRIC_TOPOLOGY"] == "8x1x1"
        assert me.parse_gpu_coords(port["GPU_COORDS"]) == {
            i: (i, 0, 0) for i in indices}

    def test_coordless_inventory_exports_nothing(self):
        gpus = [g.__class__(**{**g.__dict__, "coords": (0, 0, 0),
                               "slice_topology": ""})
                for g in gpuinfo.default_fake_gpus(2)]
        assert me.export_topology_env(gpus) == {}
        assert me.export_topology_env(gpus[:1]) == {}

    def test_one_gpu_node_declares_and_plans(self):
        """The trap the reference's coordless export sets: a lone GPU at
        (0,0,0) with no declared topology exports nothing and can never
        be planned. The backends always declare "1x1x1"."""
        (gpu,) = gpuinfo.default_fake_gpus(1)
        assert gpu.coords == (0, 0, 0) and gpu.slice_topology == "1x1x1"
        env = me.export_topology_env([gpu])
        env.update({"GPU_VISIBLE_INDICES": "0",
                    "CUDA_VISIBLE_DEVICES": gpu.uuid})
        plan = me.plan_from_env(env)
        assert plan.n_devices == 1 and plan.coords == ((0, 0, 0),)
        assert plan.gpu_keys == ((0, 0),)
        # The reference, given the same chip without its declaration,
        # refuses.
        (chip,) = reference_chips([gpu])
        bare = chip.__class__(**{**chip.__dict__, "slice_topology": ""})
        assert rme.export_topology_env([bare]) == {}
        with pytest.raises(rme.MeshBuildError, match="no TPU_CHIP_COORDS"):
            rme.plan_from_env({"TPU_VISIBLE_CHIPS": "0"})

    def test_one_gpu_of_eight_planned(self):
        gpus = gpuinfo.default_fake_gpus(8)
        env = me.export_topology_env([gpus[3]])
        env.update({"GPU_VISIBLE_INDICES": "3",
                    "CUDA_VISIBLE_DEVICES": gpus[3].uuid})
        plan = me.plan_from_env(env)
        assert plan.coords == ((3, 0, 0),) and plan.gpu_keys == ((0, 3),)


# (reference env, what the reference's message says, the port's): the
# refusal cases of tests/test_meshbuild.py, mapped by NAME_MAP.
ENV_REFUSALS = [
    ({"TPU_VISIBLE_CHIPS": "0,1", "TPU_CHIP_COORDS": "0:0.0.0",
      "TPU_SLICE_TOPOLOGY": "2x1x1", "TPU_GENERATION": "hopper"},
     "no exported coord", "no exported coord"),
    ({"TPU_VISIBLE_CHIPS": "0"}, "no TPU_CHIP_COORDS", "no GPU_COORDS"),
    ({"TPU_VISIBLE_CHIPS": "0,1x,2",
      "TPU_CHIP_COORDS": "0:0.0.0,1:1.0.0,2:2.0.0",
      "TPU_SLICE_TOPOLOGY": "4x1x1", "TPU_GENERATION": "hopper"},
     "malformed TPU_VISIBLE_CHIPS", "malformed GPU_VISIBLE_INDICES"),
    ({"TPU_VISIBLE_CHIPS": "0", "TPU_CHIP_COORDS": "0:0.0"},
     "malformed", "malformed"),
    ({"TPU_VISIBLE_CHIPS": "0,1", "TPU_CHIP_COORDS": "0:0.0.0,1:0.0.0"},
     "share coordinate", "share coordinate"),
    ({"TPU_VISIBLE_CHIPS": "0,1", "TPU_CHIP_COORDS": "0:0.0.0,1:5.0.0",
      "TPU_SLICE_TOPOLOGY": "2x1x1"}, "outside declared",
     "outside declared"),
    ({"TPU_VISIBLE_CHIPS": "0", "TPU_CHIP_COORDS": "0:0.0.0,0:1.0.0"},
     "duplicate chip index", "duplicate GPU index"),
]

WORKER_REFUSALS = [
    ([{"TPU_WORKER_ID": "0", "TPU_CHIP_COORDS": "0:0.0.0",
       "TPU_VISIBLE_CHIPS": "0"},
      {"TPU_WORKER_ID": "2", "TPU_CHIP_COORDS": "0:1.0.0",
       "TPU_VISIBLE_CHIPS": "0"}], "not the contiguous"),
    ([{"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,b,c",
       "TPU_CHIP_COORDS": "0:0.0.0", "TPU_VISIBLE_CHIPS": "0"},
      {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b,c",
       "TPU_CHIP_COORDS": "0:1.0.0", "TPU_VISIBLE_CHIPS": "0"}],
     "peer list names 3"),
    ([{"TPU_WORKER_ID": "0", "TPU_SLICE_TOPOLOGY": "2x2x2",
       "TPU_CHIP_COORDS": "0:0.0.0", "TPU_VISIBLE_CHIPS": "0"},
      {"TPU_WORKER_ID": "1", "TPU_SLICE_TOPOLOGY": "4x4x4",
       "TPU_CHIP_COORDS": "0:1.0.0", "TPU_VISIBLE_CHIPS": "0"}],
     "conflicting"),
    ([{"TPU_WORKER_ID": "0", "TPU_CHIP_COORDS": "0:0.0.0",
       "TPU_VISIBLE_CHIPS": "0"},
      {"TPU_WORKER_ID": "1", "TPU_CHIP_COORDS": "0:0.0.0",
       "TPU_VISIBLE_CHIPS": "0"}], "share coordinate"),
    ([{"TPU_WORKER_ID": "0", "TPU_GENERATION": "v5e",
       "TPU_CHIP_COORDS": "0:0.0.0", "TPU_VISIBLE_CHIPS": "0"},
      {"TPU_WORKER_ID": "1", "TPU_GENERATION": "v5p",
       "TPU_CHIP_COORDS": "0:1.0.0", "TPU_VISIBLE_CHIPS": "0"}],
     "conflicting generations"),
]
# The cddaemon's identity keys and their GPU counterparts.
WORKER_NAMES = (("TPU_WORKER_ID", "GPU_WORKER_ID"),
                ("TPU_WORKER_HOSTNAMES", "GPU_WORKER_HOSTNAMES"))


def to_port_worker(env):
    env = dict(env)
    for ref, port in WORKER_NAMES:
        if ref in env:
            env[port] = env.pop(ref)
    return to_port(env)


class TestRefusal:
    @pytest.mark.parametrize("env,ref_msg,port_msg", ENV_REFUSALS)
    def test_env_refusals_match_reference(self, env, ref_msg, port_msg):
        with pytest.raises(rme.MeshBuildError, match=ref_msg):
            rme.plan_from_env(env)
        with pytest.raises(me.MeshBuildError, match=port_msg):
            me.plan_from_env(to_port(env))

    @pytest.mark.parametrize("envs,msg", WORKER_REFUSALS)
    def test_worker_refusals_match_reference(self, envs, msg):
        with pytest.raises(rme.MeshBuildError, match=msg):
            rme.plan_from_worker_envs(envs)
        with pytest.raises(me.MeshBuildError, match=msg):
            me.plan_from_worker_envs([to_port_worker(e) for e in envs])

    def test_worker_envs_plan_matches_reference(self):
        envs = [{"TPU_WORKER_ID": str(w), "TPU_CHIP_COORDS":
                 f"0:{2 * w}.0.0,1:{2 * w + 1}.0.0",
                 "TPU_VISIBLE_CHIPS": "0,1", "TPU_SLICE_TOPOLOGY": "4x1x1"}
                for w in (1, 0)]
        ref = rme.plan_from_worker_envs(envs)
        port = me.plan_from_worker_envs([to_port_worker(e) for e in envs])
        assert plan_order(port) == plan_order(ref)

    def test_uuid_count_mismatch_refused(self):
        env = {"GPU_VISIBLE_INDICES": "0,1", "GPU_COORDS": "0:0.0.0,1:1.0.0",
               "CUDA_VISIBLE_DEVICES": "GPU-a"}
        with pytest.raises(me.MeshBuildError, match="count mismatch"):
            me.plan_from_env(env)

    @pytest.mark.parametrize("fault_site", ["mesh.build"])
    def test_mesh_build_fault_site_fires(self, fault_site):
        keyed = {(0, 0): (0, 0, 0)}
        with REF_FAULTS.armed(fault_site, RefAlways()):
            with pytest.raises(RefFaultInjected):
                rme.plan_from_coords(keyed, None, "v5e")
        with PORT_FAULTS.armed(fault_site, PortAlways()):
            with pytest.raises(PortFaultInjected):
                me.plan_from_coords(keyed, None, "hopper")


class TestPlanFromAllocation:
    def _slice(self, node, n):
        return {"metadata": {"name": f"{node}-gpu.dev"},
                "spec": {"driver": "gpu.dev", "nodeName": node,
                         "devices": [{"name": f"gpu-{i}", "attributes": {
                             "type": {"string": "gpu"},
                             "architecture": {"string": "hopper"},
                             "coordX": {"int": i}, "coordY": {"int": 0},
                             "coordZ": {"int": 0},
                             "fabricTopology": {"string": f"{n}x1x1"}}}
                             for i in range(n)]}}

    def test_double_digit_gpus_key_by_real_index(self):
        claim = {"metadata": {"name": "c"}, "status": {"allocation": {
            "devices": {"results": [
                {"pool": "n0", "device": "gpu-10"},
                {"pool": "n0", "device": "gpu-2"}]}}}}
        plan = me.plan_from_allocation(claim, [self._slice("n0", 16)])
        assert plan.gpu_keys == ((0, 2), (0, 10))
        assert plan.coords == ((2, 0, 0), (10, 0, 0))
        assert plan.generation == "hopper"

    def test_published_devices_plan_like_the_env(self, tmp_path):
        """Cluster truth and the claim env give one plan."""
        from tpu_dra_torch.gpuplugin.deviceinfo import enumerate_allocatable
        gpus = gpuinfo.default_fake_gpus(8)
        devices = [d.to_resource_api()
                   for d in enumerate_allocatable(gpus).values()]
        sl = {"metadata": {"name": "n0"},
              "spec": {"driver": "gpu.dev", "nodeName": "n0",
                       "devices": devices}}
        claim = {"status": {"allocation": {"devices": {"results": [
            {"pool": "n0", "device": f"gpu-{i}"} for i in (6, 1, 4)]}}}}
        from_slices = me.plan_from_allocation(claim, [sl])
        env = me.export_topology_env([gpus[i] for i in (1, 4, 6)])
        env["GPU_VISIBLE_INDICES"] = "1,4,6"
        assert plan_order(me.plan_from_env(env)) == plan_order(from_slices)


class TestDevices:
    def test_ordered_devices_and_grid(self):
        keyed = {(0, i): c for i, c in enumerate(
            [(3, 0, 0), (1, 0, 0), (2, 0, 0), (0, 0, 0)])}
        ref = rme.plan_from_coords(keyed, (4, 1, 1), "v5e")
        port = me.plan_from_coords(keyed, (4, 1, 1), "hopper")
        names = ["a", "b", "c", "d"]
        assert mb.ordered_devices(port, names) \
            == rmb.ordered_devices(ref, names) == ["d", "b", "c", "a"]
        grid = mb.mesh_from_plan(port, names, axis_names=("data", "model"),
                                 shape=(2, 2))
        assert grid.axis_names == ("data", "model")
        assert grid.devices.tolist() == [["d", "b"], ["c", "a"]]
        ref_mesh = rmb.mesh_from_plan(
            ref, jax.devices()[:4], axis_names=("data", "model"),
            shape=(2, 2))
        assert ref_mesh.devices.shape == grid.devices.shape

    def test_count_and_shape_refused(self):
        plan = me.plan_from_coords({(0, i): c for i, c in
                                    enumerate(line(4))}, (4, 1, 1), "hopper")
        with pytest.raises(me.MeshBuildError, match="4 devices but"):
            mb.ordered_devices(plan, ["a"])
        with pytest.raises(me.MeshBuildError, match="holds 6 devices"):
            mb.mesh_from_plan(plan, list("abcd"), axis_names=("x", "y"),
                              shape=(2, 3))
        with pytest.raises(me.MeshBuildError, match="explicit shape"):
            mb.mesh_from_plan(plan, list("abcd"), axis_names=("x", "y"))

    def test_devices_from_env_on_cpu(self):
        env = {"CUDA_VISIBLE_DEVICES": "GPU-a,GPU-b"}
        assert mb.devices_from_env(env, "cpu") == [torch.device("cpu")] * 2
        with pytest.raises(me.MeshBuildError, match="names no GPUs"):
            mb.devices_from_env({}, "cpu")

    def test_devices_from_env_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mb.devices_from_env({"CUDA_VISIBLE_DEVICES": "GPU-a"})

    def test_devices_from_env_checks_uuids(self, monkeypatch):
        """cuda:i must be the env's i-th GPU: UUIDs compared in one form
        (NVML's "GPU-" prefix and torch's bare one)."""
        seen = ["8c6b1f4e-0000-4000-8000-000000000001",
                "8c6b1f4e-0000-4000-8000-000000000002"]

        class Props:
            def __init__(self, i):
                self.uuid = seen[i]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_properties", Props)
        env = {"CUDA_VISIBLE_DEVICES": ",".join(
            "GPU-" + u.upper() for u in seen)}
        assert mb.devices_from_env(env) == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
        env = {"CUDA_VISIBLE_DEVICES": f"GPU-{seen[1]},GPU-{seen[0]}"}
        with pytest.raises(me.MeshBuildError, match="cuda:0 is GPU"):
            mb.devices_from_env(env)
        with pytest.raises(me.MeshBuildError, match="this process sees 2"):
            mb.devices_from_env({"CUDA_VISIBLE_DEVICES": "GPU-x"})


class TestLaunch:
    def test_unknown_workload_refused(self):
        plan = me.plan_from_coords({(0, 0): (0, 0, 0)}, None, "hopper")
        with pytest.raises(me.MeshBuildError, match="unknown workload"):
            mb.launch_workload("allreduce", plan, [torch.device("cpu")])

    def test_workload_launch_fault_site_fires(self):
        plan = me.plan_from_coords({(0, 0): (0, 0, 0)}, None, "hopper")
        with PORT_FAULTS.armed("workload.launch", PortAlways()):
            with pytest.raises(PortFaultInjected):
                mb.launch_workload("train", plan, [torch.device("cpu")])
        with REF_FAULTS.armed("workload.launch", RefAlways()):
            with pytest.raises(RefFaultInjected):
                rme.admit_launch("train")

    def test_train_refuses_a_device_count_mismatch(self):
        plan = me.plan_from_coords({(0, i): c for i, c in
                                    enumerate(line(2))}, None, "hopper")
        with pytest.raises(me.MeshBuildError, match="2 devices but"):
            mb.launch_workload("train", plan, [torch.device("cpu")])
        assert np.isfinite(plan.modeled_nvlink_gbps)
