"""The port's compute-domain stack end to end on the CPU: controller,
CD kubelet plugins and native domain daemons converging over the fake
API server (the behaviour test of tests/test_cd_integration.py, run on
the port), then the channel claim's env driving collectives and the
train step.

- The lifecycle: the controller stamps per-CD objects -> workload claims
  prepare on two "nodes" -> plugins label the nodes -> (the test plays
  the DaemonSet) domain daemons start, register, rendezvous, report
  Ready -> plugins release the claims with the rendezvous env -> teardown
  cleans everything.
- The port's _cd_psum_probe (entry): a 2-node domain, then gloo ranks
  meeting at the env's MASTER_ADDR:MASTER_PORT as their NODE_RANKs make
  them; the all-reduce of rank + 1 sums to n(n+1)/2 (exact).
- The CD child path: a node's GPU-claim env merged with its channel
  claim's -> plan_from_env -> launch_workload("train", domain=env) on a
  small fp32 model, its losses held against the reference's train step
  on the same GPU's claim env, the same weights (params_from_jax) and
  tokens: within 1e-4 relative (the same function summed in different
  orders). Also the claim child itself (bench.claim_child, a subprocess
  on the CPU).
- Per-node launchers: two processes, each holding only its node's env,
  meet at one TCPStore; their DP x TP step over the domain's world of
  four gloo ranks gives one launcher's four-rank step's losses within
  1e-6 relative (the same sums over the same groups). Nodes whose GPU
  counts differ are refused, not hung.
- bench_cd_gpus on four gloo CPU ranks (two nodes of two GPUs, a
  launcher process each): the four-card path, held to the psum's sum
  and the DP x TP step at (2, 2).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cdcontroller import Controller
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.k8s import (
    COMPUTEDOMAINS, DAEMONSETS, FakeCluster, NODES, RESOURCECLAIMS,
    RESOURCECLAIMTEMPLATES,
)
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.kubeletplugin.server import Claim
from tpu_dra_torch.testing import FakeNode, free_port

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER_NS = "gpu-dra-driver"
LABEL = apitypes.COMPUTE_DOMAIN_LABEL_KEY
SMALL = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq=64)
LR = 0.1
STEPS = 2
TOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_registries():
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


class TestFullConvergence:
    def test_two_node_compute_domain_lifecycle(self, tmp_path):
        cluster = FakeCluster()
        controller = Controller(cluster, namespace=DRIVER_NS,
                                image="img:test", gc_interval=3600.0)
        controller.start()
        port = free_port()   # the CD plugins' --coordinator-port
        nodes = [FakeNode(cluster, f"node-{c}", tmp_path,
                          coordinator_port=port) for c in "ab"]
        try:
            self._run(cluster, controller, nodes, tmp_path)
        finally:
            for n in nodes:
                n.stop()
            controller.stop()

    def _run(self, cluster, controller, nodes, tmp_path):
        # 1. User creates the ComputeDomain; controller stamps objects.
        cd = cluster.create(COMPUTEDOMAINS, {
            "apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
            "metadata": {"name": "train-cd", "namespace": "team"},
            "spec": {"numNodes": 2, "channel": {
                "resourceClaimTemplate": {"name": "train-rct"},
                "allocationMode": "Single"}},
        })
        uid = cd["metadata"]["uid"]
        assert cluster.wait_for(lambda: _exists(
            cluster, RESOURCECLAIMTEMPLATES, "train-rct", "team"))

        # 2. "Scheduler": instantiate the workload RCT into one claim per
        #    node, allocated on each node's channel-0.
        rct = cluster.get(RESOURCECLAIMTEMPLATES, "train-rct", "team")
        claims = []
        for node in nodes:
            spec = json.loads(json.dumps(rct["spec"]["spec"]))
            claim = cluster.create(RESOURCECLAIMS, {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": f"train-{node.name}",
                             "namespace": "team"},
                "spec": spec,
                "status": {"allocation": {"devices": {
                    "results": [{
                        "request": spec["devices"]["requests"][0]["name"],
                        "driver": apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
                        "pool": node.name, "device": "channel-0"}],
                    "config": spec["devices"].get("config", []),
                }}},
            })
            claims.append(claim)

        # 3. kubelet calls prepare on both nodes concurrently.
        results = {}

        def kubelet(node, claim):
            c = Claim(uid=claim["metadata"]["uid"],
                      name=claim["metadata"]["name"], namespace="team")
            results[node.name] = node.driver.prepare_claims([c])[c.uid]

        threads = [threading.Thread(target=kubelet, args=(n, c))
                   for n, c in zip(nodes, claims)]
        for t in threads:
            t.start()

        # 4. Plugins label their nodes; the test plays the DaemonSet and
        #    starts a daemon on each labeled node.
        for node in nodes:
            assert node.wait_labeled(uid, timeout=10), \
                f"{node.name} never labeled"
            node.start_daemon(cd)

        for t in threads:
            t.join(timeout=30)
        assert all(r.error == "" for r in results.values()), results

        # 5. Both workloads got coherent rendezvous env.
        envs = {}
        for node, claim in zip(nodes, claims):
            path = os.path.join(
                node.tmp, "cdi",
                "k8s.compute-domain.gpu.dev-claim_"
                f"{claim['metadata']['uid']}.json")
            spec = json.load(open(path))
            envs[node.name] = dict(
                e.split("=", 1)
                for e in spec["devices"][0]["containerEdits"]["env"])
        ids = sorted(int(envs[n]["GPU_WORKER_ID"]) for n in envs)
        assert ids == [0, 1]
        addrs = {envs[n]["GPU_COORDINATOR_ADDRESS"] for n in envs}
        assert len(addrs) == 1  # everyone agrees on the coordinator
        assert all(envs[n]["GPU_PROCESS_COUNT"] == "2" for n in envs)
        # ... and on one torch.distributed rendezvous, each node its rank.
        assert len({(envs[n]["MASTER_ADDR"], envs[n]["MASTER_PORT"])
                    for n in envs}) == 1
        assert sorted(envs[n]["NODE_RANK"] for n in envs) == ["0", "1"]

        # 6. CD status carries both nodes Ready (daemon-mirrored).
        def both_ready():
            st = (cluster.get(COMPUTEDOMAINS, "train-cd", "team")
                  .get("status") or {})
            n = st.get("nodes") or []
            return len(n) == 2 and all(
                x["status"] == "Ready" for x in n)
        assert cluster.wait_for(both_ready, timeout=10)

        # 7. Teardown: unprepare both claims, stop daemons, delete the CD.
        for node, claim in zip(nodes, claims):
            c = Claim(uid=claim["metadata"]["uid"],
                      name=claim["metadata"]["name"], namespace="team")
            assert node.driver.unprepare_claims([c])[c.uid] == ""
        for node in nodes:
            node.daemon.stop()
            node.daemon = None
        cluster.delete(COMPUTEDOMAINS, "train-cd", "team")
        assert cluster.wait_for(
            lambda: not _exists(cluster, COMPUTEDOMAINS, "train-cd", "team"),
            timeout=10)
        # Stamped objects and node labels are gone.
        assert cluster.list(DAEMONSETS, namespace=DRIVER_NS) == []
        for node in nodes:
            labels = (cluster.get(NODES, node.name)["metadata"]
                      .get("labels") or {})
            assert LABEL not in labels


def _exists(cluster, gvr, name, ns=None):
    try:
        cluster.get(gvr, name, ns)
        return True
    except NotFoundError:
        return False


def test_cd_psum_probe_sums_over_the_domain_rendezvous():
    """entry._cd_psum_probe on four gloo ranks, two per node: they meet
    at the channel env's MASTER_ADDR:MASTER_PORT and sum 1..4 to 10."""
    from tpu_dra_torch import entry

    rec = entry._cd_psum_probe(4)
    assert rec["ok"], rec
    assert (rec["psum_devices"], rec["psum_workers"],
            rec["gpus_per_worker"]) == (4, 2, 2)
    assert rec["value"] == rec["expected"] == 10.0
    assert rec["worker_hostnames"] == "gpu-cd-daemon-0000,gpu-cd-daemon-0001"
    assert rec["rendezvous"].startswith("127.0.0.1:")


def _one_node_domain_env():
    """The channel-claim env of a one-node domain (a simulated 8-GPU
    node), from the CD stack."""
    from tpu_dra_torch.testing import provision_multi_node_cd

    prov = provision_multi_node_cd(n_nodes=1, namespace="child")
    assert prov["ok"], prov["error"]
    assert prov["teardown"]["cd_deleted"]
    return next(iter(prov["envs"].values()))


def test_cd_child_path_trains_like_the_reference(tmp_path):
    """The CD child's path on the CPU: GPU 5's claim env (prepared by the
    port's DeviceState) merged with a one-node domain's channel env ->
    plan_from_env -> launch_workload("train", domain=env) at the domain's
    rendezvous (a world-1 gloo group on the env's TCPStore); its two SGD
    losses within TOL of the reference's step
    (test_torch_claim_path.reference_losses, tpu_dra's jitted step on
    the reference's claim env of the same GPU), same weights and
    tokens."""
    import jax

    from test_torch_claim_path import prepared_envs, reference_losses
    from tpu_dra.workloads import model as jm
    from tpu_dra_torch.topology import meshexport as me
    from tpu_dra_torch.workloads import meshbuild as mb
    from tpu_dra_torch.workloads import model as tm
    import jax.numpy as jnp

    _gpus, gpu_env, ref_env = prepared_envs(tmp_path, [5])
    channel = _one_node_domain_env()
    env = {**gpu_env, **channel}
    plan = me.plan_from_env(env)
    assert plan.coords == me.plan_from_worker_envs([env]).coords == \
        me.plan_from_env(gpu_env).coords == ((5, 0, 0),)

    cfg_j = jm.ModelConfig(**SMALL, dtype=jnp.float32)
    params_j = jm.init_params(jax.random.PRNGKey(7), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    tokens = np.random.RandomState(8).randint(
        0, SMALL["vocab"], (8, SMALL["max_seq"]))
    cfg_t = tm.ModelConfig(**SMALL, dtype=torch.float32)
    res = mb.launch_workload(
        "train", plan, mb.devices_from_env(env, "cpu"), domain=env,
        cfg=cfg_t, steps=STEPS, lr=LR,
        params=tm.params_from_jax(tree, cfg_t, "cpu"), tokens=tokens)
    assert (res["rank"], res["n_devices"]) == (0, 1)
    assert res["domain"] == {
        "rank": 0, "world": 1, "node_rank": 0, "psum": 1.0,
        "rendezvous": f"{channel['MASTER_ADDR']}:{channel['MASTER_PORT']}"}
    want = reference_losses(ref_env, params_j, tokens, "auto")
    got = res["losses"]
    assert got[1] < got[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL * abs(w), (got, want)


def _node_envs(n_nodes, gpus_per_node, port):
    """The merged envs of `n_nodes` nodes of `gpus_per_node` GPUs each
    (one node's NVLink places, indices 0..) in one domain at
    127.0.0.1:`port`."""
    coords = ",".join(f"{i}:{i}.0.0" for i in range(gpus_per_node))
    return [{"GPU_WORKER_ID": str(k), "GPU_COORDS": coords,
             "GPU_VISIBLE_INDICES": ",".join(map(str, range(gpus_per_node))),
             "GPU_FABRIC_TOPOLOGY": f"{gpus_per_node}x1x1",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "NODE_RANK": str(k), "NNODES": str(n_nodes)}
            for k in range(n_nodes)]


def test_domain_layout_refuses_a_rank_the_env_does_not_give():
    """A node whose env places it outside the domain (NODE_RANK 2 of
    NNODES 2) is refused before it binds or joins a store, not hung."""
    from tpu_dra_torch.topology import meshexport as me
    from tpu_dra_torch.workloads import meshbuild as mb

    env = dict(_node_envs(2, 1, free_port())[1], NODE_RANK="2")
    plan = me.plan_from_env(env)
    with pytest.raises(ValueError, match="node 2 of 2"):
        mb.launch_workload("train", plan, [torch.device("cpu")],
                           domain=env)


def test_node_launchers_meet_at_one_rendezvous():
    """Two launcher processes, each holding only its node's env (two
    GPUs, NODE_RANK 0 and 1 of 2), meet at one TCPStore as ranks 0-1 and
    2-3 of four; their DP x TP step at (2, 2) gives the losses of one
    launcher's four ranks on a plan of all four devices within 1e-6
    relative (the same sums over the same groups; measured equal)."""
    from tpu_dra_torch.testing import reserve_port, run_nodes
    from tpu_dra_torch.topology import meshexport as me
    from tpu_dra_torch.workloads import meshbuild as mb
    from tpu_dra_torch.workloads import model as tm

    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    tokens = np.random.RandomState(3).randint(
        0, SMALL["vocab"], (4, SMALL["max_seq"]))
    runs = [("train", {"cfg": cfg, "steps": STEPS, "lr": LR,
                       "tokens": tokens})]
    hold = reserve_port()
    try:
        envs = _node_envs(2, 2, hold.getsockname()[1])
        cpus = [torch.device("cpu")] * 2
        nodes = run_nodes(mb.launch_workloads,
                          [(runs, me.plan_from_env(e), cpus, e)
                           for e in envs], timeout_s=300)
    finally:
        hold.close()
    places = [n["train"]["domain"] for n in nodes]
    assert [(p["rank"], p["world"], p["node_rank"], p["psum"])
            for p in places] == [(0, 4, 0, 10.0), (2, 4, 1, 10.0)]
    assert [n["train"]["grid"] for n in nodes] == [[2, 2]] * 2
    assert nodes[0]["train"]["losses"] == nodes[1]["train"]["losses"]
    one = _node_envs(1, 4, 0)[0]
    want = mb.launch_workload("train", me.plan_from_env(one),
                              [torch.device("cpu")] * 4, **runs[0][1])
    for g, w in zip(nodes[0]["train"]["losses"], want["losses"]):
        assert abs(g - w) <= 1e-6 * abs(w), (nodes, want)


def test_nodes_with_other_gpu_counts_are_refused():
    """Node 0 holds two GPUs (a world of four), node 1 one (a world of
    two, where it would be rank 1): node 1's rank reads the world rank
    0 serves and refuses at once; the launch raises, naming it."""
    from tpu_dra_torch.testing import reserve_port, run_nodes
    from tpu_dra_torch.topology import meshexport as me
    from tpu_dra_torch.workloads import meshbuild as mb

    hold = reserve_port()
    try:
        port = hold.getsockname()[1]
        envs = [_node_envs(2, 2, port)[0], _node_envs(2, 1, port)[1]]
        runs = [("allreduce", {"iters": 1})]
        with pytest.raises(RuntimeError, match="serves one of 4"):
            run_nodes(mb.launch_workloads,
                      [(runs, me.plan_from_env(e),
                        [torch.device("cpu")] * (2 - k), e)
                       for k, e in enumerate(envs)], timeout_s=120)
    finally:
        hold.close()


def test_claim_child_with_domain_env_on_cpu(tmp_path):
    """`python -m tpu_dra_torch.bench claim-child` with a merged env (the
    process the card's compute_domain phase starts; its NODE_RANK makes
    it a domain's node), on the CPU and a small model: finite losses,
    rank 0 of 1, at the env's rendezvous."""
    from test_torch_claim_path import prepared_envs

    _gpus, gpu_env, _ref_env = prepared_envs(tmp_path, [2])
    channel = _one_node_domain_env()
    cfg = json.dumps(dict(SMALL, dtype="float32"))
    env = {**os.environ, **gpu_env, **channel, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dra_torch.bench", "claim-child",
         "--device-type", "cpu", "--steps", "2",
         "--config", cfg], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert (out["rank"], out["n_devices"]) == (0, 1)
    assert out["domain"]["rendezvous"] == \
        f"{channel['MASTER_ADDR']}:{channel['MASTER_PORT']}"
    assert out["claim_uuids"] == [gpu_env["CUDA_VISIBLE_DEVICES"]]


def test_bench_cd_gpus_on_four_cpu_ranks():
    """bench_cd_gpus, the four-card path, on a FakeBackend node of four
    GPUs and gloo CPU ranks: two simulated nodes of two GPUs, a launcher
    process each, the psum of rank + 1 over the domain's rendezvous (10,
    exact, read by each node's first rank), the all-reduce and the
    DP x TP step at (2, 2) with finite losses."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.native import gpuinfo

    cfg = bench.DATAPLANE_TRAIN
    res = bench.bench_cd_gpus(
        backend=gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(4)),
        device_type="cpu",
        allreduce_kw={"nbytes_per_device": 1 << 20, "iters": 2},
        train_kw={"cfg": cfg, "steps": 2, "tokens": np.random.RandomState(
            0).randint(0, cfg.vocab, (4, cfg.max_seq))})
    assert res["psum"] == {"values": [10.0] * 2, "expected": 10.0,
                           "ok": True}
    assert res["node_ranks"] == ["0", "1"]
    assert res["train_grid"] == [2, 2]
    assert res["records"]["allreduce"]["n_devices"] == 4
    assert all(np.isfinite(res["records"]["train"]["losses"]))
    left = res["teardown"]
    assert left["cd_deleted"] and not left["labeled_nodes"] \
        and not left["daemonsets"] and not left["templates"]
