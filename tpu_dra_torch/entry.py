"""Entry points of the port (counterpart of __graft_entry__.py): the
flagship model's forward and its arguments at the default ModelConfig,
and the multi-device dry run over gloo CPU ranks."""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_dra_torch.workloads.model import (
    ModelConfig, TransformerLM, init_params, resolve_device,
)


def entry(device="cuda"):
    """(fn, args) with fn(*args) -> logits. fn is the TransformerLM
    module (it holds its parameters, drawn from seed 0); args are the
    reference's tokens (numpy RandomState(0), shape [2, max_seq])."""
    device = resolve_device(device)
    cfg = ModelConfig()
    model = TransformerLM(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), device))
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, (2, cfg.max_seq)),
        dtype=torch.long, device=device)
    return model, (tokens,)


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def _dryrun_rank() -> dict:
    """This rank's part of dryrun_multichip: every section, each checked
    finite and of the expected shape. Returns one reading per section."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads import _dist
    from tpu_dra_torch.workloads import moe_model as mm
    from tpu_dra_torch.workloads.model import (
        build_train_step, shard_params,
    )
    from tpu_dra_torch.workloads.moe import (
        init_moe_params, make_expert_parallel_ffn, shard_moe_params,
    )
    from tpu_dra_torch.workloads.pipeline import (
        init_stage_params, make_pipeline_forward, shard_stage_params,
    )
    from tpu_dra_torch.workloads.ringattention import make_ring_attention
    from tpu_dra_torch.workloads.sp_train import make_sp_train_step
    from tpu_dra_torch.workloads.ulysses import make_ulysses_attention

    n = dist.get_world_size()
    cpus = np.empty(n, dtype=object)
    cpus[:] = [torch.device("cpu")] * n
    out = {}

    def check(name, ok, value):
        if not ok:
            raise RuntimeError(f"dryrun section {name}: {value}")
        out[name] = value

    # 2-D mesh: TP over pairs, DP across the rest.
    model_axis = 2 if n % 2 == 0 else 1
    mesh = _dist.Mesh(cpus.reshape(n // model_axis, model_axis),
                      ("data", "model"))
    cfg = ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                      max_seq=16)
    batch = n // model_axis * 2   # divisible by the 'data' axis
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, (batch, cfg.max_seq)))
    model = TransformerLM(cfg, shard_params(init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), mesh, cfg), mesh)
    loss = float(build_train_step(model)(tokens))
    check("dp_tp_loss", math.isfinite(loss), loss)

    # Sequence parallelism over a 1-D ("seq",) mesh of the same ranks:
    # the ring, then all-to-all (Ulysses, H % n == 0).
    seq_mesh = _dist.Mesh(cpus, ("seq",))
    s_local, b, h, d = 8, 2, 2, 16
    for name, heads, make in (("ring", h, make_ring_attention),
                              ("ulysses", n, make_ulysses_attention)):
        shape = (b, n * s_local, heads, d)
        qkv = [torch.as_tensor(np.random.RandomState(i).standard_normal(
            shape), dtype=torch.float32) for i in range(3)]
        local = [_dist.shard(x, seq_mesh, "seq", 1) for x in qkv]
        with torch.no_grad():
            o = make(seq_mesh, axis_name="seq")(*local)
        check(name, o.shape == local[0].shape and _finite(o),
              list(o.shape))

    # Context-parallel training: d_model scales with n (d_head 4).
    sp_cfg = ModelConfig(vocab=64, d_model=n * 4, n_heads=n, n_layers=2,
                         d_ff=64, max_seq=n * s_local, dtype=torch.float32)
    sp_model = TransformerLM(sp_cfg, init_params(
        sp_cfg, torch.Generator().manual_seed(11), "cpu"), seq_mesh)
    sp_tokens = torch.as_tensor(np.random.RandomState(12).randint(
        0, sp_cfg.vocab, (2, sp_cfg.max_seq)))
    loss = float(make_sp_train_step(sp_model, seq_mesh)(sp_tokens))
    check("sp_train_loss", math.isfinite(loss), loss)

    # Expert parallelism: one expert per rank.
    ep_mesh = _dist.Mesh(cpus, ("expert",))
    moe = shard_moe_params(init_moe_params(
        torch.Generator().manual_seed(1), 16, 32, n), ep_mesh)
    xs = torch.as_tensor(np.random.RandomState(3).standard_normal(
        (2, 16, 16)), dtype=torch.float32)
    with torch.no_grad():
        y, aux = make_expert_parallel_ffn(ep_mesh)(moe, xs)
    check("ep_ffn_aux", y.shape == xs.shape and _finite(aux), float(aux))

    # The MoE LM's train step on the DP x TP mesh, experts on 'model'.
    moe_cfg = mm.MoEModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                                d_ff=64, max_seq=16,
                                n_experts=max(2, model_axis))
    lm = mm.MoETransformerLM(moe_cfg, mm.shard_params(mm.init_params(
        moe_cfg, torch.Generator().manual_seed(5), "cpu"), mesh, moe_cfg),
        mesh)
    mm_tokens = torch.as_tensor(np.random.RandomState(5).randint(
        0, moe_cfg.vocab, (batch, moe_cfg.max_seq)))
    loss = float(mm.make_train_step(lm)(mm_tokens))
    check("moe_lm_loss", math.isfinite(loss), loss)

    # Pipeline parallelism: GPipe over a stage axis.
    pp_mesh = _dist.Mesh(cpus, ("stage",))
    weights = shard_stage_params(init_stage_params(
        torch.Generator().manual_seed(2), n, 16), pp_mesh)
    mbs = torch.as_tensor(np.random.RandomState(4).standard_normal(
        (6, 2, 16)), dtype=torch.float32)
    pp = make_pipeline_forward(pp_mesh)(weights, mbs)
    check("pipeline", pp.shape == mbs.shape and _finite(pp), list(pp.shape))
    return out


def _psum_node(env: dict, n: int) -> list:
    """One node of _cd_psum_probe: `n` gloo CPU ranks of the domain whose
    channel-claim env `env` is, each reading psum_of_ranks."""
    from tpu_dra_torch.workloads._dist import RankPool, psum_of_ranks

    with RankPool([torch.device("cpu")] * n, domain=env) as pool:
        return pool.run(psum_of_ranks)


def _cd_psum_probe(n_devices: int) -> dict:
    """The counterpart of __graft_entry__._cd_psum_probe: provision a
    2-node ComputeDomain through the port's stack (controller, CD kubelet
    plugins and native domain daemons over the fake API server,
    testing.DomainSim), read each node's prepared channel-claim env and,
    while the domain is up, start one process per node (run_nodes) that
    holds only its own env and starts its share of `n_devices` gloo CPU
    ranks; they meet at the env's MASTER_ADDR:MASTER_PORT, each as the
    rank its node's NODE_RANK makes it (_dist.domain_rank). Their
    all-reduce of rank + 1 must sum to n(n+1)/2. Returns the reading
    with "ok"."""
    from tpu_dra_torch.testing import DomainSim, run_nodes

    with DomainSim(dict.fromkeys(("node-a", "node-b")),
                   namespace="dryrun") as sim:
        cd = sim.create_cd()
        prov = sim.prepare_channels(cd)
        if not prov["ok"]:
            return {"ok": False, "error": prov["error"]}
        envs = sorted(prov["envs"].values(),
                      key=lambda e: int(e["NODE_RANK"]))
        worker_ids = [int(e["GPU_WORKER_ID"]) for e in envs]
        if worker_ids != list(range(len(envs))):
            return {"ok": False,
                    "error": f"non-contiguous worker ids {worker_ids}"}
        n_workers = len(envs)
        per_worker = n_devices // n_workers
        n_total = n_workers * per_worker
        got = [v for node in run_nodes(
            _psum_node, [(env, per_worker) for env in envs]) for v in node]
        sim.teardown(cd, prov["claims"])
    expect = n_total * (n_total + 1) / 2.0
    return {
        "ok": all(abs(g - expect) < 1e-3 for g in got),
        "psum_devices": n_total, "psum_workers": n_workers,
        "gpus_per_worker": per_worker,
        "value": got[0], "expected": expect,
        "convergence_s": prov["elapsed_s"],
        "worker_hostnames": envs[0].get("GPU_WORKER_HOSTNAMES", ""),
        "coordinator": envs[0].get("GPU_COORDINATOR_ADDRESS", ""),
        "rendezvous": f"{envs[0]['MASTER_ADDR']}:{envs[0]['MASTER_PORT']}",
    }


def dryrun_multichip(n_devices: int) -> dict:
    """The counterpart of __graft_entry__.dryrun_multichip: every section
    of its _dryrun_body — the DP x TP train step, ring attention,
    Ulysses, the sequence-parallel train step, the expert-parallel FFN,
    the MoE LM's step and the pipeline — on `n_devices` spawned gloo CPU
    ranks, each section checked finite and of its shape; then the
    compute-domain psum (_cd_psum_probe, reading "cd_psum"), which must
    sum right. It validates the layouts and their collectives, not a
    device's speed. Returns rank 0's readings."""
    from tpu_dra_torch.workloads._dist import RankPool

    with RankPool([torch.device("cpu")] * n_devices) as pool:
        out = pool.run(_dryrun_rank)[0]
    record = _cd_psum_probe(n_devices)
    if not record["ok"]:
        raise RuntimeError(f"compute-domain psum probe failed: {record}")
    out["cd_psum"] = record
    return out
