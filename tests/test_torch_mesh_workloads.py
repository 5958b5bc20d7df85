"""Port parity: meshbuild's registered workloads launched from a
FakeBackend claim's CDI env, the DP x TP "train" workload over every
device of the plan, entry.dryrun_multichip and bench_mesh_dataplane,
against the reference's launcher (tpu_dra/workloads/meshbuild.py) on
its 8-device CPU mesh.

The claim is prepared by the port's DeviceState over a fake 8-GPU HGX
node; its env is planned (plan_from_env) and mapped to one CPU device
per GPU (devices_from_env(env, "cpu")). The workloads run on four
spawned gloo ranks (one RankPool for the module), where
launch_workload finds a group up and runs each rank's part; the
reference's records come from its own launcher over a plan of the same
GPUs on four of its CPU devices.

The "train" comparison is fp32: the global loss within 1e-5 relative,
each leaf's update within 1e-4 of its own max plus 1e-6 of the leaf's
max |value| (test_torch_parallel_model's bounds).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch import bench as tbench
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.topology.meshexport import MeshBuildError, plan_from_env
from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import meshbuild as mb
from tpu_dra_torch.workloads import model as tm

torch.set_num_threads(2)

WORLD = 4
SMALL = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=32)
LR = 0.1


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """(port claim env, reference claim env) of GPUs 0-3."""
    from test_torch_claim_path import prepared_envs

    _, env, ref_env = prepared_envs(tmp_path_factory.mktemp("claim"),
                                    list(range(WORLD)))
    return env, ref_env


def _launch_task(name, plan, devices, kw):
    return mb.launch_workload(name, plan, devices, **kw)


def _reference_keys(ref_env, name):
    import jax

    from tpu_dra.topology import meshexport as rme
    from tpu_dra.workloads import meshbuild as rmb

    plan = rme.plan_from_env(ref_env)
    return set(rmb.launch_workload(name, plan, jax.devices()[:WORLD],
                                   iters=1))


TRAIN_KEYS = {"workload", "losses", "loss", "step_times_s", "steps",
              "device", "window", "n_devices", "n_layers", "batch", "seq",
              "rank", "grid", "coords", "local_batch", "local_param_elems"}


@pytest.mark.parametrize("name", sorted(mb.WORKLOADS))
def test_workload_runs_from_the_claim_env(pool, envs, name):
    """Every registered workload on the claim's four GPUs (Ulysses with
    as many heads as ranks): each rank returns a record with the
    reference launcher's keys, finite and positive where they are
    rates."""
    env, ref_env = envs
    plan = plan_from_env(env)
    devices = mb.devices_from_env(env, "cpu")
    kw = {"iters": 1}
    if name == "train":
        kw = {"cfg": tm.ModelConfig(**SMALL, dtype=torch.float32),
              "steps": 1, "tokens": np.random.RandomState(0).randint(
                  0, SMALL["vocab"], (4, SMALL["max_seq"]))}
    recs = pool.run(_launch_task, name, plan, devices, kw)
    want = TRAIN_KEYS if name == "train" else _reference_keys(ref_env, name)
    for rec in recs:
        assert set(rec) == want
        rates = [v for k, v in rec.items()
                 if k.endswith(("_per_s", "gbps", "wall_ms"))]
        assert all(np.isfinite(r) and r > 0 for r in rates), rec
    if name in ("ringattention", "ulysses", "sp_train"):
        assert recs[0]["seq"] == _reference_seq(ref_env, name)


def _reference_seq(ref_env, name):
    import jax

    from tpu_dra.topology import meshexport as rme
    from tpu_dra.workloads import meshbuild as rmb

    return rmb.launch_workload(name, rme.plan_from_env(ref_env),
                               jax.devices()[:WORLD], iters=1)["seq"]


def _reference_train(tree, tokens, grid):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import model as jm

    cfg = jm.ModelConfig(**SMALL, dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(grid),
                ("data", "model"))
    step = jm.make_train_step(jm.TransformerLM(cfg), mesh, lr=LR)
    params = jm.shard_params(jax.tree.map(jnp.asarray, tree), mesh, cfg)
    new, loss = step(params, jnp.asarray(tokens))
    return jax.tree.map(np.asarray, new), float(loss)


def _named(tree):
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, bp in enumerate(tree["blocks"]):
        for name, leaf in bp.items():
            out[f"blocks.{i}.{name}"] = np.asarray(leaf, np.float32)
    return out


def test_rate_record_keeps_a_toy_rate_above_zero():
    """The toy MoE step does 65,536 FLOPs; on a loaded host its wall time
    passes 0.131 s, where a rate rounded to 3 decimals of GFLOP/s reads
    0.0 and the record above would claim no work was done."""
    rec = mb._rate_record(0.2, 65_536.0)
    assert rec["gflops_per_s"] > 0
    assert rec["gflops_per_s"] == pytest.approx(65_536.0 / 0.2 / 1e9,
                                                rel=1e-12)


def test_train_runs_on_every_device_of_the_plan(pool, envs):
    """The repair of "train": a 4-GPU claim trains on all four ranks as
    the DP x TP step over a (2, 2) grid, each rank on its own 'data'
    block of the batch with its own 'model' shard of the weights; the
    loss and the gathered weights are the reference's (2, 2) step's."""
    import jax

    from tpu_dra.workloads import model as jm

    env, _ = envs
    plan = plan_from_env(env)
    devices = mb.devices_from_env(env, "cpu")
    cfg_j = jm.ModelConfig(**SMALL)
    tree = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0),
                                                 cfg_j))
    tokens = np.random.RandomState(1).randint(0, SMALL["vocab"],
                                              (4, SMALL["max_seq"]))
    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    recs = pool.run(_launch_task, "train", plan, devices, {
        "cfg": cfg, "steps": 1, "lr": LR, "keep_params": True,
        "params": tm.params_from_jax(tree, cfg, "cpu"), "tokens": tokens})
    assert [r["rank"] for r in recs] == list(range(WORLD))
    assert all(r["grid"] == [2, 2] for r in recs)
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in recs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    full = sum(np.asarray(x).size for x in _named(tree).values())
    for r in recs:
        assert r["n_devices"] == WORLD and r["batch"] == 4
        assert r["local_batch"] == 2
        # Each rank holds half of every sharded leaf (all but the norms).
        assert r["local_param_elems"] < 0.51 * full
    new, loss = _reference_train(tree, tokens, (2, 2))
    assert len({r["loss"] for r in recs}) == 1
    assert abs(recs[0]["loss"] - loss) <= 1e-5 * loss
    column = sorted((r for r in recs if r["coords"]["data"] == 0),
                    key=lambda r: r["coords"]["model"])
    got = _named(tm.unshard_params([r["params"] for r in column], cfg))
    for name, w in _named(new).items():
        o = _named(tree)[name]
        scale = np.abs(w - o).max()
        err = np.abs((got[name] - o) - (w - o)).max()
        assert err <= 1e-4 * scale + 1e-6 * np.abs(o).max(), name


def test_launch_spawns_a_rank_per_device(envs):
    """With no group up, launch_workload starts one process per plan
    device and returns rank 0's record (here a 2-GPU claim's plan)."""
    env, _ = envs
    two = {**env, "CUDA_VISIBLE_DEVICES": ",".join(
        env["CUDA_VISIBLE_DEVICES"].split(",")[:2]),
        "GPU_VISIBLE_INDICES": "0,1"}
    plan = plan_from_env(two)
    rec = mb.launch_workload("pipeline", plan,
                             mb.devices_from_env(two, "cpu"), iters=1)
    assert rec["stages"] == 2 and rec["wall_ms"] > 0
    assert not torch.distributed.is_initialized()


def test_one_device_runs_in_process(envs):
    env, _ = envs
    one = {**env, "CUDA_VISIBLE_DEVICES": env["CUDA_VISIBLE_DEVICES"]
           .split(",")[0], "GPU_VISIBLE_INDICES": "0"}
    plan = plan_from_env(one)
    rec = mb.launch_workload("allreduce", plan,
                             mb.devices_from_env(one, "cpu"))
    assert rec == {"algo_gbps": 0.0, "bus_gbps": 0.0, "n_devices": 1}
    assert not torch.distributed.is_initialized()


def test_unknown_workload_and_admission_fault_refused(envs):
    env, _ = envs
    plan = plan_from_env(env)
    devices = mb.devices_from_env(env, "cpu")
    with pytest.raises(MeshBuildError, match="unknown workload"):
        mb.launch_workload("nope", plan, devices)
    from tpu_dra_torch.infra.faults import EveryNth

    PORT_FAULTS.arm("workload.launch", EveryNth(1))
    try:
        with pytest.raises(Exception, match="workload.launch"):
            mb.launch_workload("allreduce", plan, devices)
    finally:
        PORT_FAULTS.reset()


def test_dryrun_multichip_four_ranks():
    """Every section of the reference's _dryrun_body, its compute-domain
    psum probe too, on four gloo ranks: each reading finite, each shape
    right, the probe's sum 1 + 2 + 3 + 4 over the domain's rendezvous."""
    from tpu_dra_torch import entry

    out = entry.dryrun_multichip(4)
    assert set(out) == {"dp_tp_loss", "ring", "ulysses", "sp_train_loss",
                        "ep_ffn_aux", "moe_lm_loss", "pipeline", "cd_psum"}
    assert out["cd_psum"]["ok"]
    assert out["cd_psum"]["value"] == out["cd_psum"]["expected"] == 10.0
    assert all(np.isfinite(out[k]) for k in ("dp_tp_loss", "sp_train_loss",
                                             "ep_ffn_aux", "moe_lm_loss"))
    assert out["ring"] == [2, 8, 2, 16] and out["ulysses"] == [2, 8, 4, 16]
    assert out["pipeline"] == [6, 2, 16]


def test_mesh_dataplane_runs_every_workload_on_eight_ranks():
    out = tbench.bench_mesh_dataplane()
    assert out["psum_mesh_workers"] == 2
    assert out["psum_mesh_allocated_gpus"] == 8
    assert out["psum_mesh_contiguous"]
    assert out["psum_mesh_coverage"] == "8/8"
    assert out["psum_mesh_devices"] == 8 and out["psum_mesh_algo_gbps"] > 0
    for name in mb.WORKLOADS:
        if name != "allreduce":
            assert any(k.startswith(f"mesh_workload_{name}_") for k in out)
    assert out["mesh_workload_train_grid"] == [4, 2]
