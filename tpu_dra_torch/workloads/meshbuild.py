"""Devices and workloads from a driver allocation (counterpart of
tpu_dra/workloads/meshbuild.py).

A prepared claim's CDI env names the GPUs (their UUIDs in
``CUDA_VISIBLE_DEVICES``) and their NVLink coordinates; the
:class:`~tpu_dra_torch.topology.meshexport.MeshPlan` built from that env
fixes a deterministic rank order. This module maps the env's UUIDs to
the ``torch.device``s of the process that reads it
(``devices_from_env``), lays them out in the plan's order
(``ordered_devices``, ``mesh_from_plan``) and runs a workload on them
(``launch_workload``). Every launch passes the ``workload.launch``
admission seam and every plan the ``mesh.build`` one.

Registered workloads: the reference's six (``"allreduce"``,
``"ringattention"``, ``"ulysses"``, ``"moe"``, ``"pipeline"``,
``"sp_train"``, with its records' keys and default sizes) and
``"train"``, the flagship TransformerLM's DP x TP step. Each runs as
SPMD code, one process per device, over a ``torch.distributed`` group
(``_dist``): ``launch_workload`` runs this rank's part when a group is
up and otherwise starts one, in-process at world 1 and over spawned
ranks for more devices. With ``domain`` (this node's ComputeDomain
channel-claim env) the node's GPUs are its ranks of the domain's world
and meet the other nodes' at the domain's rendezvous.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_dra_torch.topology.meshexport import (
    ENV_CUDA_VISIBLE, MeshBuildError, MeshPlan, admit_launch,
)
from tpu_dra_torch.workloads import _dist


def ordered_devices(plan: MeshPlan, devices: Sequence) -> List:
    """Permute `devices` into the plan's rank order. `devices` is the
    arrival-order list — one device per allocated GPU, aligned with the
    plan's (worker_index, gpu_index)-sorted arrival order. Refuses a
    count mismatch: a mesh over the wrong device count is a
    rank/topology lie."""
    if len(devices) != plan.n_devices:
        raise MeshBuildError(
            f"allocation plans {plan.n_devices} devices but "
            f"{len(devices)} devices were supplied")
    return [devices[i] for i in plan.order]


@dataclass(frozen=True)
class DeviceGrid:
    """The plan-ordered devices laid out as an N-D array with its axis
    names (what a ``_dist.Mesh`` is built from)."""
    devices: np.ndarray
    axis_names: tuple


def mesh_from_plan(plan: MeshPlan, devices: Sequence,
                   axis_names: Sequence[str] = ("x",),
                   shape: Optional[Sequence[int]] = None) -> DeviceGrid:
    """The plan-ordered devices as a grid. Default is the 1-D collective
    layout; pass `axis_names` + `shape` for N-D layouts (the product must
    equal the device count — checked, not truncated)."""
    devs = ordered_devices(plan, devices)
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None or len(shape) != len(axis_names):
        raise MeshBuildError(
            f"axis_names {tuple(axis_names)} need an explicit shape")
    n = 1
    for d in shape:
        n *= d
    if n != len(devs):
        raise MeshBuildError(
            f"mesh shape {tuple(shape)} holds {n} devices but the "
            f"allocation has {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return DeviceGrid(grid.reshape(tuple(shape)), tuple(axis_names))


def normalize_uuid(uuid) -> str:
    """A GPU or MIG-device UUID as NVML ("GPU-8c6b...", "MIG-1f2e...")
    and torch ("8c6b...") print it, reduced to one form for comparison:
    CUDA reports a MIG device's own UUID as the device's."""
    text = str(uuid).strip().lower()
    return text[4:] if text.startswith(("gpu-", "mig-")) else text


def devices_from_env(env: Dict[str, str], device_type: str = "cuda"
                     ) -> List[torch.device]:
    """The claim's GPUs as this process's devices, in the env's order
    (node-index order, the plan's arrival order); a MIG device's "MIG-"
    UUID names it in its GPU's place. With
    ``CUDA_VISIBLE_DEVICES`` applied before CUDA initialised, the
    process's i-th CUDA device is the env's i-th UUID; each is checked
    against the device's own UUID. ``device_type="cpu"`` stands one CPU
    device in for each GPU, for the CPU tier."""
    uuids = [u.strip() for u in env.get(ENV_CUDA_VISIBLE, "").split(",")
             if u.strip()]
    if not uuids:
        raise MeshBuildError(f"claim env names no GPUs in {ENV_CUDA_VISIBLE}")
    if device_type == "cpu":
        return [torch.device("cpu")] * len(uuids)
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if n != len(uuids):
        raise MeshBuildError(
            f"the claim env names {len(uuids)} GPUs but this process sees "
            f"{n} (was CUDA initialised before the env was applied?)")
    out = []
    for i, uuid in enumerate(uuids):
        seen = normalize_uuid(torch.cuda.get_device_properties(i).uuid)
        if seen != normalize_uuid(uuid):
            raise MeshBuildError(
                f"cuda:{i} is GPU {seen}, the claim env's GPU {i} is {uuid}")
        out.append(torch.device("cuda", i))
    return out




# ---------------------------------------------------------------------------
# Workloads: each runs as this rank's part over a process group whose
# ranks are the plan's devices in rank order (launch_workload starts one
# when none is up). Small, measured runs; shapes scale with the plan.
# ---------------------------------------------------------------------------

def process_mesh(plan: MeshPlan, devices: Sequence,
                 axis_names: Sequence[str] = ("x",),
                 shape: Optional[Sequence[int]] = None) -> _dist.Mesh:
    """This rank's _dist.Mesh over mesh_from_plan's grid (collective:
    every rank of the group builds it)."""
    return _dist.Mesh.from_grid(mesh_from_plan(plan, devices, axis_names,
                                               shape))


def _timed(fn: Callable, device, iters: int = 2) -> float:
    """Mean wall seconds per call after one warm call; every call ends in
    a device synchronize and a barrier over the group, so the time is
    that of the slowest rank."""
    fn()
    _dist.barrier(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _dist.barrier(device)
    return (time.perf_counter() - t0) / iters


def _randn(seed: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """numpy RandomState(seed) normals, as the reference draws them."""
    return torch.as_tensor(np.random.RandomState(seed).standard_normal(shape),
                           dtype=dtype, device=device)


def _attention_inputs(n: int, heads: int, device, s_local: int = 8,
                      b: int = 2, d: int = 16):
    shape = (b, n * s_local, heads, d)
    return [_randn(i, shape, device) for i in range(3)], shape


def _rate_record(wall_s: float, flops: float, **extra) -> Dict:
    """A workload's wall time and rate. The rate stays unrounded: a toy
    step of a few kFLOPs over a loaded host's wall time is far below any
    fixed number of decimals, and a rate rounded to 0 reads as no work."""
    return {"wall_ms": round(wall_s * 1e3, 3),
            "gflops_per_s": flops / wall_s / 1e9, **extra}


def _run_allreduce(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.infra.metrics import PSUM_BW
    from tpu_dra_torch.workloads.allreduce import allreduce_bandwidth

    mesh = process_mesh(plan, devices)
    r = allreduce_bandwidth(
        nbytes_per_device=int(kw.get("nbytes_per_device", 1 << 18)),
        iters=int(kw.get("iters", 4)), warmup=2, group=mesh.group("x"),
        device=mesh.device)
    if r["algo_gbps"] > 0:
        PSUM_BW.observe(r["algo_gbps"])
    return {"algo_gbps": round(r["algo_gbps"], 3),
            "bus_gbps": round(r["bus_gbps"], 3),
            "n_devices": int(r["n_devices"])}


# The reference's attention workloads run at s_local 8 and a head dim of
# 4 (sp_train); on a card they run at the least the kernels take: the
# flash ring's s_local 128 (ring_flash_ok) and head dim 16.
_RING_S_LOCAL = {"cpu": 8, "cuda": 128}
_SP_HEAD_DIM = {"cpu": 4, "cuda": 16}


@torch.no_grad()
def _run_ringattention(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.workloads.ringattention import make_ring_attention

    mesh = process_mesh(plan, devices, axis_names=("seq",))
    n = plan.n_devices
    qkv, (b, s, h, d) = _attention_inputs(
        n, 2, mesh.device, _RING_S_LOCAL[mesh.device.type])
    q, k, v = (_dist.shard(x, mesh, "seq", 1) for x in qkv)
    fn = make_ring_attention(mesh, axis_name="seq")
    wall_s = _timed(lambda: fn(q, k, v), mesh.device,
                    iters=int(kw.get("iters", 2)))
    # qk^T + att@v, forward
    return _rate_record(wall_s, 4.0 * b * s * s * h * d, seq=s)


@torch.no_grad()
def _run_ulysses(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.workloads.ulysses import make_ulysses_attention

    mesh = process_mesh(plan, devices, axis_names=("seq",))
    n = plan.n_devices
    # H % axis_size == 0
    qkv, (b, s, h, d) = _attention_inputs(n, n, mesh.device)
    q, k, v = (_dist.shard(x, mesh, "seq", 1) for x in qkv)
    fn = make_ulysses_attention(mesh, axis_name="seq")
    wall_s = _timed(lambda: fn(q, k, v), mesh.device,
                    iters=int(kw.get("iters", 2)))
    return _rate_record(wall_s, 4.0 * b * s * s * h * d, seq=s)


@torch.no_grad()
def _run_moe(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.workloads.moe import (
        init_moe_params, make_expert_parallel_ffn, shard_moe_params,
    )

    mesh = process_mesh(plan, devices, axis_names=("expert",))
    n = plan.n_devices
    d_model, d_ff = 16, 32
    params = shard_moe_params(init_moe_params(
        torch.Generator().manual_seed(1), d_model, d_ff, n,
        device=mesh.device), mesh)
    x = _randn(3, (2, 16, d_model), mesh.device)
    fn = make_expert_parallel_ffn(mesh)
    wall_s = _timed(lambda: fn(params, x), mesh.device,
                    iters=int(kw.get("iters", 2)))
    tokens = x.shape[0] * x.shape[1]
    # up + down matmuls, forward
    return _rate_record(wall_s, 2.0 * tokens * d_model * d_ff * 2,
                        tokens_per_s=round(tokens / wall_s, 1))


def _run_pipeline(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.workloads.pipeline import (
        init_stage_params, make_pipeline_forward, shard_stage_params,
    )

    mesh = process_mesh(plan, devices, axis_names=("stage",))
    n = plan.n_devices
    d = 16
    weights = shard_stage_params(init_stage_params(
        torch.Generator().manual_seed(2), n, d).to(mesh.device), mesh)
    mbs = _randn(4, (6, 2, d), mesh.device)
    fn = make_pipeline_forward(mesh)
    wall_s = _timed(lambda: fn(weights, mbs), mesh.device,
                    iters=int(kw.get("iters", 2)))
    return {"wall_ms": round(wall_s * 1e3, 3),
            "microbatches_per_s": round(mbs.shape[0] / wall_s, 1),
            "stages": n}


def _run_sp_train(plan: MeshPlan, devices: Sequence, **kw) -> Dict:
    from tpu_dra_torch.workloads.model import (
        ModelConfig, TransformerLM, init_params,
    )
    from tpu_dra_torch.workloads.sp_train import make_sp_train_step

    mesh = process_mesh(plan, devices, axis_names=("seq",))
    n = plan.n_devices
    d_head = _SP_HEAD_DIM[mesh.device.type]
    cfg = ModelConfig(vocab=64, d_model=n * d_head, n_heads=n, n_layers=2,
                      d_ff=64, max_seq=n * 8, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(11), mesh.device)
    tokens = torch.as_tensor(
        np.random.RandomState(12).randint(0, cfg.vocab, (2, cfg.max_seq)),
        dtype=torch.long, device=mesh.device)
    step = make_sp_train_step(TransformerLM(cfg, params, mesh), mesh)
    wall_s = _timed(lambda: step(tokens), mesh.device,
                    iters=int(kw.get("iters", 2)))
    tokens_per_step = tokens.shape[0] * (cfg.max_seq - 1)
    return {"wall_ms": round(wall_s * 1e3, 3),
            "tokens_per_s": round(tokens_per_step / wall_s, 1),
            "seq": cfg.max_seq}


def train_grid(n: int) -> tuple:
    """The ('data', 'model') grid "train" lays over n devices: TP over
    pairs, DP across the rest (__graft_entry__._dryrun_body's layout)."""
    model_axis = 2 if n % 2 == 0 else 1
    return (n // model_axis, model_axis)


def _run_train(plan: MeshPlan, devices: Sequence, *, cfg=None,
               steps: int = 3, params=None, tokens=None,
               lr: float = 1e-3, warm_steps: int = 0,
               barrier: Optional[Callable[[], None]] = None,
               keep_params: bool = False) -> Dict:
    """`steps` SGD steps of the TransformerLM (the flagship config by
    default; weights from seed 0 and tokens of the flagship batch from
    numpy RandomState(0) unless `params`, the full tree, and `tokens`,
    the global batch, are given) as the DP x TP step over the plan's
    ('data', 'model') grid (train_grid; (1, 1) on one device), after
    `warm_steps` untimed ones and then `barrier()` (a tenant of a shared
    claim waits there for the others). This rank
    trains on its 'data' block of the batch with its 'model' shard of
    the weights. Returns every timed step's global loss and wall time
    (each step ends in a loss fetch, which synchronizes the device), the
    host-clock window (time.time() at the first step's start and the
    last one's end), this rank's place and share, and with
    `keep_params` its parameter shards after the steps (numpy)."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads.model import (
        TransformerLM, build_train_step, init_params, local_params,
        shard_params, tree_map,
    )

    grid = train_grid(plan.n_devices)
    mesh = process_mesh(plan, devices, ("data", "model"), grid)
    device = mesh.device
    cfg = cfg or bench.FLAGSHIP
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
    local = tree_map(lambda x: x.to(device), shard_params(params, mesh, cfg))
    del params
    model = TransformerLM(cfg, local, mesh)
    if tokens is None:
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab, (bench.FLAGSHIP_BATCH, cfg.max_seq))
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
    step = build_train_step(model, lr=lr)
    for _ in range(warm_steps):
        float(step(tokens))
    if barrier is not None:
        barrier()
    losses, times = [], []
    window_start = time.time()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        times.append(time.perf_counter() - t0)
    rec = {"workload": "train", "losses": losses, "loss": losses[-1],
           "step_times_s": times, "steps": steps, "device": str(device),
           "window": [window_start, time.time()],
           "n_devices": plan.n_devices, "n_layers": cfg.n_layers,
           "batch": int(tokens.shape[0]), "seq": int(tokens.shape[1]),
           "rank": mesh.rank, "grid": list(grid), "coords": mesh.coords,
           "local_batch": int(tokens.shape[0]) // grid[0],
           "local_param_elems": sum(p.numel() for p in model.parameters())}
    if keep_params:
        rec["params"] = local_params(model)
    return rec


WORKLOADS: Dict[str, Callable] = {
    "allreduce": _run_allreduce,
    "ringattention": _run_ringattention,
    "ulysses": _run_ulysses,
    "moe": _run_moe,
    "pipeline": _run_pipeline,
    "sp_train": _run_sp_train,
    "train": _run_train,
}


def default_runs(allreduce_kw: Dict, train_kw: Dict) -> List[tuple]:
    """Every registered workload once, in WORKLOADS' order (the
    all-reduce first, "train" last), as launch_workloads takes them: the
    all-reduce with `allreduce_kw`, "train" with `train_kw`, the others
    at their default sizes."""
    kws = {"allreduce": allreduce_kw, "train": train_kw}
    return [(name, dict(kws.get(name, {}))) for name in WORKLOADS]


def _rank_part(name: str, plan: MeshPlan, devices: Sequence, kw: Dict):
    rec = WORKLOADS[name](plan, devices, **kw)
    place = _dist.domain_place()
    return rec if place is None else {**rec, "domain": place}


def _domain_world(plan: MeshPlan, devices: Sequence, env: Dict[str, str]
                  ) -> tuple:
    """(plan, devices) of a ComputeDomain's world as the node whose plan,
    devices (arrival order) and channel-claim env these are sees it: each
    of the env's NNODES nodes holds this node's plan, and node k's ranks
    are k*n .. k*n + n - 1 in that plan's order (_dist.domain_rank). The
    other nodes' devices are None here: no process of this node runs
    them. The nodes share no NVLink fabric, so the ring hops and the
    modeled bandwidth stay the node's own."""
    node_rank, _ = _dist.domain_rank(env, 0, 1)
    n_nodes, n = int(env["NNODES"]), plan.n_devices
    world = dataclasses.replace(
        plan, coords=plan.coords * n_nodes,
        gpu_keys=tuple((k, g) for k in range(n_nodes)
                       for _, g in plan.gpu_keys),
        order=tuple(k * n + i for k in range(n_nodes) for i in plan.order),
        contiguous=plan.contiguous and n_nodes == 1,
        hops=plan.hops * n_nodes, n_workers=n_nodes)
    slots = [None] * (n * n_nodes)
    slots[node_rank * n:(node_rank + 1) * n] = list(devices)
    return world, slots


def launch_workloads(runs: Sequence, plan: MeshPlan, devices: Sequence,
                     domain: Optional[Dict[str, str]] = None
                     ) -> Dict[str, Dict]:
    """Run each (name, kwargs) of `runs` in turn on the allocation's
    devices and return {name: rank 0's record}. Unknown names refuse; the
    workload.launch admission seam runs first for each. If a process
    group is up, this is this rank's part. If none is, one is started
    for the runs and stopped after: in this process for one device, else
    one spawned process per plan device (rank r pinned to the plan's
    r-th device). With `domain` (this node's ComputeDomain channel-claim
    env) `plan` and `devices` are this node's: its GPUs become the ranks
    NODE_RANK*n .. NODE_RANK*n + n - 1 of a world of NNODES*n, which
    every node of the domain starts the same way and which meets at the
    env's rendezvous (_dist.start_domain_group); the workloads run over
    that world (_domain_world), and the record, this node's first
    rank's, carries its place under "domain"."""
    runs = [(name, dict(kw)) for name, kw in runs]
    for name, _ in runs:
        if name not in WORKLOADS:
            raise MeshBuildError(
                f"unknown workload {name!r} (known: {sorted(WORKLOADS)})")
        admit_launch(name)
    if _dist.is_up():
        return {name: _rank_part(name, plan, devices, kw)
                for name, kw in runs}
    devs = ordered_devices(plan, devices)
    if domain is not None:
        plan, devices = _domain_world(plan, devices, domain)
    if len(devs) == 1:
        if domain is None:
            _dist.start_local_group(devs[0])
        else:
            _dist.start_domain_group(domain, devs[0])
        try:
            return {name: _rank_part(name, plan, devices, kw)
                    for name, kw in runs}
        finally:
            _dist.stop_group()
    with _dist.RankPool(devs, domain=domain) as pool:
        return {name: pool.run(_rank_part, name, plan, devices, kw)[0]
                for name, kw in runs}


def launch_workload(name: str, plan: MeshPlan, devices: Sequence,
                    domain: Optional[Dict[str, str]] = None,
                    **kw) -> Dict:
    """Run workload `name` on the allocation's devices and return its
    record ({wall_ms, bandwidth or rate, ...}; rank 0's when the plan
    has several devices); see launch_workloads."""
    return launch_workloads([(name, kw)], plan, devices, domain)[name]
