"""Train-step throughput of the flagship model on one NVIDIA GPU, the
workload library's data plane, and claim-to-ready of the kubelet plugin
(counterpart of bench.py's bench_mfu, bench_long_context, bench_psum,
bench_mesh_dataplane, bench_claim_to_ready and their helpers).

bench_mfu, bench_long_context and bench_moe are device measurements:
they run on a CUDA device or raise. bench_psum times the all-reduce over
a claim's GPUs, and bench_mesh_dataplane runs every workload of
meshbuild on a fake 2-worker x 4-GPU slice (testing.MeshSliceHarness)
over gloo CPU ranks.
bench_claim_to_ready times the kubelet plugin over its sockets on any
discovery backend.
bench_shared_claim runs one claim's tenants (train-step processes,
``claim-child`` below) at once, with the default config or MPS.
bench_cd_convergence times a two-node ComputeDomain from creation to both
channel claims prepared (host time, the controller, CD plugins and native
domain daemons over the fake API server); bench_cd_gpus runs the node's
GPUs as the ranks of a two-node domain.
The ops benches (bench_fake_inventory_configs, bench_prepare_sustained,
bench_sched_churn, bench_topology, bench_sched_failover,
bench_trace_overhead) read the control plane on the host's clock, as do
bench_chaos_recovery (plugin crash to claim ready again, on the fake node
or a passed backend) and bench_sched_scale10k (the scheduler pool's
churn at scale-out with a hollow-node watcher fleet, against a
same-process baseline).

    python -m tpu_dra_torch.bench
    # one JSON line each: shared_claim and mps (one claim, two flagship
    # tenants), mfu, long_ctx (S=8192), long_ctx_xl (S=16384) and at
    # remat "dots" and "full", moe (the MoE LM), psum (the node's GPUs),
    # claim_to_ready (the node's GPUs through NVML) and mesh_dataplane
    # (every workload on an 8-GPU fake claim, over gloo CPU ranks)
    python -m tpu_dra_torch.bench mesh
    # one JSON line: every workload over every GPU of the node, one NCCL
    # rank per GPU (bench_mesh_gpus)
    python -m tpu_dra_torch.bench cd
    # one JSON line: the node's GPUs split over two simulated nodes of a
    # ComputeDomain, one NCCL rank per GPU meeting at the domain's
    # MASTER_ADDR: the all-reduce's sum, the all-reduce and the flagship
    # DP x TP step (bench_cd_gpus)
    python -m tpu_dra_torch.bench ops
    # one JSON line each, on the host alone (no GPU needed): the MIG and
    # MPS claim-to-ready on a fake inventory (fake_inventory), sustained
    # prepare/unprepare (prepare_sustained), scheduler churn, topology
    # and failover on fake GPU nodes, the tracer's cost (ops_benches)
    python -m tpu_dra_torch.bench chaos
    # one JSON line: bench_chaos_recovery on the fake node (host alone)
    python -m tpu_dra_torch.bench scale10k
    # one JSON line: bench_sched_scale10k at its TPU_DRA_BENCH_SCALE10K_*
    # sizes (host alone; the defaults take a long while)
    python -m tpu_dra_torch.bench claim-child [--steps N] [--wait-go] ...
    # one tenant of the claim whose CDI env is this process's environment

Where a step's device time goes: the train step opens named ranges
(tpu_dra_torch.infra.trace.DEVICE_SPANS: ``step``, ``step.forward``,
``step.backward``, ``step.sgd``, ``attention.fwd``, ``attention.bwd``,
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``)
whenever torch.profiler records, so they appear in any torch.profiler
or Chrome trace of a training pod, and the MoE router counts
``moe.kept``, ``moe.slots`` and ``moe.routed`` over the profiled steps
(``read_counters()``). ``python3 -m portbench --workload <cell> --seed
<n> --seconds 10 --trace 1`` reads them per phase and layer.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import numpy as np
import torch

from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.workloads.model import (
    ModelConfig, TransformerLM, init_params, make_train_step, resolve_device,
)

FLAGSHIP = ModelConfig(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
                       d_ff=8192, max_seq=1024)
FLAGSHIP_BATCH = 8
# Attention forwards per block per step under each remat policy: the
# recomputed block runs its forward again in the backward.
FORWARD_RUNS = {"none": 1, "dots": 2, "full": 2}
LONG_CONTEXT_BATCH = 1

log = logging.getLogger("tpu_dra_torch.bench")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(cfg: ModelConfig, batch: int, device: torch.device):
    """(model, tokens, step): weights from seed 0, tokens from numpy
    RandomState(0), as the reference's bench draws them. An
    MoEModelConfig builds the MoE LM, its weights drawn on the device."""
    from tpu_dra_torch.workloads import moe_model

    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, (batch, cfg.max_seq)),
        dtype=torch.long, device=device)
    if isinstance(cfg, moe_model.MoEModelConfig):
        gen = torch.Generator(device=device).manual_seed(0)
        model = moe_model.MoETransformerLM(
            cfg, moe_model.init_params(cfg, gen, device))
        return model, tokens, moe_model.make_train_step(model)
    model = TransformerLM(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), device))
    return model, tokens, make_train_step(model)


def _require_card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"this measures a CUDA device; got {device}")
    return device


def _train_step_rate(cfg: ModelConfig, batch: int, steps: int, device):
    """(step_s, final loss, model, step calls made). Two-point timing:
    one warm step, then 1 and 1 + `steps` chained steps, each run ending
    in a device synchronize; the constant per-run overhead cancels in the
    difference."""
    device = resolve_device(device)
    model, tokens, step = _setup(cfg, batch, device)

    def run(n):
        _sync(device)
        t0 = time.perf_counter()
        loss = None
        for _ in range(n):
            loss = step(tokens)
        _sync(device)
        return time.perf_counter() - t0, float(loss)

    run(1)  # warm: allocator, cuBLAS handles, kernel libraries
    t_small, _ = run(1)
    t_big, loss_v = run(1 + steps)
    return max((t_big - t_small) / steps, 1e-9), loss_v, model, 3 + steps


def _flops_per_token(cfg, n_params: int):
    """(flops_per_token, matmul_params): standard 6*N fwd+bwd matmul
    accounting over *matmul-participating* params plus causal attention
    score/value matmuls (6*L*S*D per token). The input embedding table is
    excluded from the 6N term: its forward op is a gather, not a matmul
    (the unembed projection is a real matmul and stays). Counting the
    gather table inflated round-2 MFU by ~12%. Shared by bench_mfu and
    bench_long_context so their MFU numbers stay comparable."""
    matmul_params = n_params - cfg.vocab * cfg.d_model
    return (6 * matmul_params
            + 6 * cfg.n_layers * cfg.max_seq * cfg.d_model), matmul_params


def bench_mfu(steps: int = 10, device="cuda") -> dict:
    """Train-step throughput of the flagship config (B8, S1024, bf16
    matmul path, fp32 masters) on one card: step time, tokens/s, achieved
    model TFLOP/s and MFU against the card's published dense bf16 peak
    (None for a card the peak table does not know)."""
    device = _require_card(device)
    cfg, batch = FLAGSHIP, FLAGSHIP_BATCH
    step_s, loss_v, model, calls = _train_step_rate(cfg, batch, steps,
                                                    device)
    if not math.isfinite(loss_v):
        raise RuntimeError(f"non-finite loss: {loss_v}")
    n_params = sum(p.numel() for p in model.parameters())
    # Trained tokens per step: the loss consumes seq-1 positions.
    tokens_per_step = batch * (cfg.max_seq - 1)
    flops_per_token, matmul_params = _flops_per_token(cfg, n_params)
    step_tflops = flops_per_token * tokens_per_step / step_s / 1e12
    name = torch.cuda.get_device_name(device)
    peak = gpuinfo.PEAK_BF16_TFLOPS.get(name)
    return {
        "mfu_model_params": int(n_params),
        "mfu_matmul_params": int(matmul_params),
        "train_step_s": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "step_tflops_per_s": step_tflops,
        "mfu": None if peak is None else step_tflops / peak,
        "peak_bf16_tflops": peak,
        "loss": loss_v,
        "step_calls": calls,
        "n_layers": cfg.n_layers,
        "device_name": name,
        "power_limit": gpuinfo.power_limit(device.index or 0),
    }


def long_context_config(seq: int) -> ModelConfig:
    """The flagship model at max_seq=`seq` (bench.py:1863-1864)."""
    return dataclasses.replace(FLAGSHIP, max_seq=seq)


def bench_long_context(steps: int = 4, seq: int = 8192,
                       prefix: str = "long_ctx", device="cuda",
                       remat: str = "none") -> dict:
    """Long-context train step of the flagship model on one card, batch 1
    (counterpart of bench.py:bench_long_context): attention goes through
    the same three kernels at every S, where the reference moves to its
    streaming kernels past its VMEM budget (S=16384 in bf16). Returns the
    reference's keys ({prefix}_seq, _step_s, _tokens_per_s with seq - 1
    trained tokens per step, and _mfu against the card's dense bf16 peak,
    None for a card the peak table does not know) plus the final loss,
    the step calls made, the depth, the peak of allocated device memory
    and the card's name and power limit. `remat` is the model's
    rematerialization policy ("none", "dots", "full"); the record names
    it and how many times each block's attention forward runs per step
    (``forward_runs``: 2 under recomputation, which the kernels' launch
    through ctypes puts outside any checkpoint policy)."""
    device = _require_card(device)
    cfg = dataclasses.replace(long_context_config(seq), remat=remat)
    torch.cuda.reset_peak_memory_stats(device)
    step_s, loss_v, model, calls = _train_step_rate(cfg, LONG_CONTEXT_BATCH,
                                                    steps, device)
    peak_bytes = torch.cuda.max_memory_allocated(device)
    if not math.isfinite(loss_v):
        raise RuntimeError(f"non-finite long-context loss: {loss_v}")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_step = LONG_CONTEXT_BATCH * (cfg.max_seq - 1)
    flops_per_token, _ = _flops_per_token(cfg, n_params)
    name = torch.cuda.get_device_name(device)
    peak = gpuinfo.PEAK_BF16_TFLOPS.get(name)
    step_tflops = flops_per_token * tokens_per_step / step_s / 1e12
    return {
        f"{prefix}_seq": cfg.max_seq,
        f"{prefix}_step_s": step_s,
        f"{prefix}_tokens_per_s": tokens_per_step / step_s,
        f"{prefix}_mfu": None if peak is None else step_tflops / peak,
        "remat": remat,
        "forward_runs": FORWARD_RUNS[remat],
        "loss": loss_v,
        "step_calls": calls,
        "n_layers": cfg.n_layers,
        "peak_memory_bytes": peak_bytes,
        "device_name": name,
        "power_limit": gpuinfo.power_limit(device.index or 0),
    }


def moe_config():
    """The MoE LM at the flagship's widths with MoEModelConfig's
    defaults (8 experts, an MoE FFN every second block, capacity factor
    1.25, aux weight 1e-2)."""
    from tpu_dra_torch.workloads.moe_model import MoEModelConfig

    return MoEModelConfig(**{f.name: getattr(FLAGSHIP, f.name)
                             for f in dataclasses.fields(FLAGSHIP)})


def bench_moe(steps: int = 3, device="cuda") -> dict:
    """Train-step throughput of the MoE LM (moe_config(), batch 8 as the
    flagship's) on one card: step time, tokens/s, the allocator's peak,
    the parameter count and the final loss (LM loss plus the weighted
    router aux)."""
    device = _require_card(device)
    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats(device)
    step_s, loss_v, model, calls = _train_step_rate(cfg, FLAGSHIP_BATCH,
                                                    steps, device)
    if not math.isfinite(loss_v):
        raise RuntimeError(f"non-finite MoE loss: {loss_v}")
    tokens_per_step = FLAGSHIP_BATCH * (cfg.max_seq - 1)
    return {
        "moe_step_s": step_s,
        "moe_tokens_per_s": tokens_per_step / step_s,
        "moe_model_params": int(sum(p.numel() for p in model.parameters())),
        "n_experts": cfg.n_experts,
        "moe_blocks": sum(cfg.is_moe_block(i) for i in range(cfg.n_layers)),
        "loss": loss_v,
        "step_calls": calls,
        "n_layers": cfg.n_layers,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
        "device_name": torch.cuda.get_device_name(device),
        "power_limit": gpuinfo.power_limit(device.index or 0),
    }


# ---------------------------------------------------------------------------
# The all-reduce probe and the workload data plane
# ---------------------------------------------------------------------------

def bench_psum(env: dict, allocated_gpus: "int | None" = None,
               device_type: str = "cuda") -> dict:
    """The all-reduce over the GPUs a claim's env names (counterpart of
    bench.py:bench_psum): each UUID of its CUDA_VISIBLE_DEVICES resolved
    against this process's devices; coverage is measured against the
    GPUs the claim allocated. One GPU has no collective to measure: both
    rates read 0.0 with a skip_reason, and local_hbm_proxy_gbps keeps a
    memory-bandwidth trend. No resolved GPU is an error, not a subset."""
    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import meshbuild
    from tpu_dra_torch.workloads.allreduce import (
        allreduce_bandwidth, local_hbm_bandwidth,
    )

    want = [u.strip() for u in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
            if u.strip()]
    if device_type == "cpu":
        seen = {meshbuild.normalize_uuid(u): torch.device("cpu")
                for u in want}
    else:
        _require_card(device_type)
        seen = {meshbuild.normalize_uuid(
            torch.cuda.get_device_properties(i).uuid): torch.device("cuda", i)
            for i in range(torch.cuda.device_count())}
    missing = [u for u in want if meshbuild.normalize_uuid(u) not in seen]
    resolved = [seen[meshbuild.normalize_uuid(u)] for u in want
                if meshbuild.normalize_uuid(u) in seen]
    if not resolved:
        raise RuntimeError(f"no claimed GPU resolved to a device (claimed="
                           f"{want}, visible={sorted(seen)})")
    allocated = allocated_gpus if allocated_gpus is not None else len(want)
    payload = (64 << 20) if device_type == "cuda" else (4 << 20)
    if len(resolved) == 1:
        r = allreduce_bandwidth(nbytes_per_device=payload)
        local = local_hbm_bandwidth(nbytes=payload, device=resolved[0])
        r["local_hbm_proxy_gbps"] = round(local["hbm_proxy_gbps"], 1)
        r["skip_reason"] = (
            f"single device visible (claim allocated {allocated} "
            f"GPU{'s' if allocated != 1 else ''}): no NVLink collective "
            "to measure")
    else:
        plan = plan_from_env(env)
        r = meshbuild.launch_workload("allreduce", plan, resolved,
                                      nbytes_per_device=payload, iters=10)
    r["platform"] = "gpu" if device_type == "cuda" else "cpu"
    r["coverage"] = f"{len(resolved)}/{allocated}"
    if missing:
        r["coverage_error"] = f"claimed GPUs {missing} not visible as devices"
    return r


def claim_env(n_gpus: int = 8) -> dict:
    """The CDI env of a claim of all `n_gpus` GPUs of a FakeBackend node
    (an HGX H100 board), prepared by DeviceState and read back through
    the CDI handler as a container runtime would; nothing is left on
    disk."""
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.cdi.handler import CDIHandler
    from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
    from tpu_dra_torch.gpuplugin.device_state import DeviceState

    root = tempfile.mkdtemp(prefix="claim_env_")
    cdi = CDIHandler(os.path.join(root, "cdi"))
    state = DeviceState(
        backend=gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(n_gpus)),
        cdi=cdi, checkpoints=CheckpointManager(os.path.join(root, "plugin")),
        driver_name=GPU_DRIVER_NAME, node_name=BENCH_NODE)
    try:
        res = state.prepare({
            "metadata": {"uid": "dataplane", "name": "dataplane",
                         "namespace": "default"},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": GPU_DRIVER_NAME,
                 "pool": BENCH_NODE, "device": f"gpu-{i}"}
                for i in range(n_gpus)], "config": []}}}})
        if res.error:
            raise RuntimeError(f"prepare failed: {res.error}")
        env = cdi.container_edits(
            [i for d in res.devices for i in d.cdi_device_ids])["env"]
        state.unprepare("dataplane")
        return env
    finally:
        state.close()
        shutil.rmtree(root, ignore_errors=True)


def node_env(backend) -> dict:
    """The env of a claim of every GPU `backend` lists, as the device
    plane exports it (the UUIDs, indices and NVLink coordinates)."""
    from tpu_dra_torch.topology.meshexport import (
        ENV_CUDA_VISIBLE, ENV_VISIBLE_INDICES, export_topology_env,
    )

    gpus = backend.gpus()
    env = dict(export_topology_env(gpus))
    env[ENV_CUDA_VISIBLE] = ",".join(g.uuid for g in gpus)
    env[ENV_VISIBLE_INDICES] = ",".join(str(g.index) for g in gpus)
    return env


def bench_mesh_gpus(train_steps: int = 3) -> dict:
    """Every registered workload over every GPU of this node, one NCCL
    rank per GPU (meshbuild.launch_workloads on the plan of a claim of
    them all): the all-reduce at 64 MiB per rank (10 iterations), the
    others at their default sizes, "train" the flagship as the DP x TP
    step over train_grid(n) for `train_steps` timed steps after one warm
    step; then bench_psum over the same env. Returns rank 0's records
    and the train step's median and global tokens/s."""
    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import meshbuild

    _cuda.build()   # once, before the ranks load the libraries
    nvml = gpuinfo.NativeBackend()
    try:
        env = node_env(nvml)
    finally:
        nvml.close()
    plan = plan_from_env(env)
    devices = meshbuild.devices_from_env(env, "cuda")
    runs = meshbuild.default_runs(
        {"nbytes_per_device": 64 << 20, "iters": 10},
        {"steps": train_steps, "warm_steps": 1})
    recs = meshbuild.launch_workloads(runs, plan, devices)
    train = recs["train"]
    step_s = statistics.median(train["step_times_s"])
    return {"n_gpus": plan.n_devices, "records": recs,
            "train_median_step_s": step_s,
            "train_tokens_per_s": train["batch"] * (train["seq"] - 1)
            / step_s,
            "psum": bench_psum(env),
            "device_name": torch.cuda.get_device_name(0),
            "power_limit": gpuinfo.power_limit(0)}


# The "train" workload's config on the data plane's CPU ranks (the CPU
# dryrun's model, __graft_entry__._dryrun_body).
DATAPLANE_TRAIN = ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                              d_ff=64, max_seq=16, dtype=torch.float32)

# The data plane's fake slice: (workers, GPUs per worker).
MESH_SLICE = (2, 4)


def bench_mesh_dataplane() -> dict:
    """Every registered workload on the plan of a MESH_SLICE fake
    multi-worker GPU slice, over one spawned gloo CPU rank per GPU
    (counterpart of bench.py:bench_mesh_dataplane, whose data plane runs
    on a CPU mesh in a subprocess). The plan is built the way the reference's
    _mesh_dataplane_collect builds it: ``testing.MeshSliceHarness``
    prepares one all-GPUs claim per worker through the real pipeline,
    and ``plan_from_worker_envs`` merges the claims' CDI envs. The
    all-reduce runs first (4 MiB per rank, 6 iterations), then the rest
    at their default sizes, "train" at DATAPLANE_TRAIN. Host-clock
    readings of CPU collectives: a check that every workload runs on the
    slice's plan, not a device rate."""
    from tpu_dra_torch.infra.metrics import PSUM_BW
    from tpu_dra_torch.testing import MeshSliceHarness
    from tpu_dra_torch.topology.meshexport import plan_from_worker_envs
    from tpu_dra_torch.workloads import meshbuild

    harness = MeshSliceHarness(*MESH_SLICE)
    try:
        envs = harness.worker_envs()
        plan = plan_from_worker_envs(envs)
        devices = [d for env in envs
                   for d in meshbuild.devices_from_env(env, "cpu")]
    finally:
        harness.close()
    out = {"psum_mesh_workers": plan.n_workers,
           "psum_mesh_allocated_gpus": plan.n_devices,
           "psum_mesh_contiguous": plan.contiguous,
           "psum_mesh_hop_mean": round(plan.hop_mean, 3),
           "psum_mesh_modeled_nvlink_gbps": round(
               plan.modeled_nvlink_gbps, 3),
           "psum_mesh_coverage": f"{len(devices)}/{plan.n_devices}"}
    data = meshbuild.train_grid(plan.n_devices)[0]
    runs = meshbuild.default_runs(
        {"nbytes_per_device": 4 << 20, "iters": 6},
        {"cfg": DATAPLANE_TRAIN, "steps": 2,
         "tokens": np.random.RandomState(0).randint(
             0, DATAPLANE_TRAIN.vocab, (2 * data, DATAPLANE_TRAIN.max_seq))})
    recs = meshbuild.launch_workloads(runs, plan, devices)
    psum = recs.pop("allreduce")
    out["psum_mesh_devices"] = psum["n_devices"]
    out["psum_mesh_algo_gbps"] = psum["algo_gbps"]
    out["psum_mesh_bus_gbps"] = psum["bus_gbps"]
    if psum["algo_gbps"] > 0:
        PSUM_BW.observe(psum["algo_gbps"])
    for name, rec in recs.items():
        for k, v in rec.items():
            if k not in ("window", "step_times_s", "losses", "coords"):
                out[f"mesh_workload_{name}_{k}"] = v
    return out


# ---------------------------------------------------------------------------
# Claim-to-ready: the kubelet plugin over its sockets
# ---------------------------------------------------------------------------

BENCH_NODE = "bench-node"


def _make_claim(cluster, gpus, name, configs=None, devices=None):
    """Allocated ResourceClaim as the scheduler would produce. `gpus` are
    GPU indices (exclusive whole-GPU devices); `devices` overrides them
    with explicit device names; `configs` carries opaque per-claim
    config (sharing strategies)."""
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.k8s import RESOURCECLAIMS

    devices = devices if devices is not None else [f"gpu-{g}" for g in gpus]
    return cluster.create(RESOURCECLAIMS, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"devices": {"requests": [{"name": "gpu"}]}},
        "status": {"allocation": {"devices": {"results": [
            {"request": "gpu", "driver": GPU_DRIVER_NAME,
             "pool": BENCH_NODE, "device": d} for d in devices],
            "config": configs or []}}},
    })


def _pctl(sorted_vals, q):
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def grpc_unavailable() -> "str | None":
    """Why the kubelet gRPC transport cannot run here (the failed import),
    or None when ``grpc`` imports."""
    from tpu_dra_torch.kubeletplugin.server import import_grpc

    try:
        import_grpc()
    except RuntimeError as e:
        return str(e.__cause__ or e)
    return None


class _BenchDriver:
    """A full node-driver stack (GpuDriver with its DRA sockets, CDI
    handler and checkpoint journal over a FakeCluster) plus a
    kubelet-acting client on the framed socket, and on the gRPC socket
    where ``grpc`` imports. Everything lives in a fresh directory under
    `scratch` (the process's temporary directory by default); `cluster`
    is the FakeCluster to publish into (a fresh one by default). With `mps_binary` (the argv of
    ``nvidia-cuda-mps-control`` or a stand-in) the state has an
    MpsManager, and an MpsNodeSim plays kubelet for its daemon
    Deployments; their directories sit under a short temporary path,
    since the daemon's pipe sockets must fit in 107 bytes. With
    `multiprocess` alone the state has the MpsManager and no node sim:
    the caller's cluster makes the daemon Deployments ready (the
    reference's multiprocess bench driver)."""

    def __init__(self, backend, scratch=None, mps_binary=None,
                 cluster=None, multiprocess=False):
        from tpu_dra_torch.gpuplugin.sharing import MpsManager
        from tpu_dra_torch.k8s import FakeCluster
        from tpu_dra_torch.testing import MpsNodeSim

        self.backend = backend
        self.cluster = cluster if cluster is not None else FakeCluster()
        self.tmp = tempfile.mkdtemp(prefix="ctr-", dir=scratch)
        self.cdi_dir = os.path.join(self.tmp, "cdi")
        self.mps_root = self.mps_sim = self._mps_manager = None
        if mps_binary is not None or multiprocess:
            self.mps_root = tempfile.mkdtemp(prefix="mps-")
            self._mps_manager = MpsManager(backend, self.cluster,
                                           node_name=BENCH_NODE,
                                           namespace=MPS_NAMESPACE,
                                           root_dir=self.mps_root)
        if mps_binary is not None:
            self.mps_sim = MpsNodeSim(self.cluster, MPS_NAMESPACE,
                                      binary=mps_binary).start()
        self.grpc_unavailable = grpc_unavailable()
        self._start()
        if not self.driver.first_published.is_set():
            raise RuntimeError("the plugin's first ResourceSlice publish "
                               "did not land")
        self.gpus = [g.index for g in backend.gpus()]

    def _start(self):
        """One plugin incarnation over the node's dirs: CDI handler,
        DeviceState over the checkpoint journal (recovering what it
        holds), GpuDriver, and the kubelet-acting clients."""
        from tpu_dra_torch.api.types import GPU_DRIVER_NAME
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState
        from tpu_dra_torch.gpuplugin.driver import GpuDriver
        from tpu_dra_torch.gpuplugin.sharing import TimeSlicingManager
        from tpu_dra_torch.kubeletplugin.server import (
            framed_stubs, kubelet_stubs,
        )

        self.cdi = CDIHandler(self.cdi_dir,
                              driver_root=os.path.join(self.tmp, "drv"))
        self.state = DeviceState(
            backend=self.backend, cdi=self.cdi,
            checkpoints=CheckpointManager(os.path.join(self.tmp, "p")),
            driver_name=GPU_DRIVER_NAME, node_name=BENCH_NODE,
            ts_manager=TimeSlicingManager(self.backend),
            mps_manager=self._mps_manager)
        self.driver = GpuDriver(state=self.state, client=self.cluster,
                                driver_name=GPU_DRIVER_NAME,
                                node_name=BENCH_NODE,
                                plugin_dir=os.path.join(self.tmp, "p"),
                                registry_dir=os.path.join(self.tmp, "r"),
                                kubelet_grpc=self.grpc_unavailable is None)
        self.driver.start()
        self.channel = None
        self._prepare_grpc = self._unprepare_grpc = None
        if self.grpc_unavailable is None:
            self.channel, self._prepare_grpc, self._unprepare_grpc = \
                kubelet_stubs(self.driver.server.dra_socket)
        self.framed_client, self._prepare_framed, self._unprepare_framed = \
            framed_stubs(self.driver.server.fast_socket, timeout_s=60.0)

    def stubs(self, transport=None):
        """(prepare, unprepare) callables for `transport` ("grpc", else
        the framed socket)."""
        if transport == "grpc":
            if self._prepare_grpc is None:
                raise RuntimeError(f"no gRPC transport: "
                                   f"{self.grpc_unavailable}")
            return self._prepare_grpc, self._unprepare_grpc
        return self._prepare_framed, self._unprepare_framed

    @staticmethod
    def _request(objs):
        from tpu_dra_torch.kubeletplugin import wire

        return [wire.Claim(uid=o["metadata"]["uid"],
                           name=o["metadata"]["name"],
                           namespace=o["metadata"]["namespace"])
                for o in objs]

    def prepare(self, obj, transport=None):
        from tpu_dra_torch.kubeletplugin import wire

        uid = obj["metadata"]["uid"]
        prepare, _ = self.stubs(transport)
        resp = prepare(wire.NodePrepareResourcesRequest(
            claims=self._request([obj])))
        res = resp.claims.get(uid)
        if res is None or res.error:
            raise RuntimeError(
                f"prepare failed: {res.error if res else 'no entry'}")
        return res

    def unprepare(self, objs, transport=None):
        from tpu_dra_torch.kubeletplugin import wire

        _, unprepare = self.stubs(transport)
        resp = unprepare(wire.NodeUnprepareResourcesRequest(
            claims=self._request(objs)))
        errors = {u: r.error for u, r in resp.claims.items() if r.error}
        if errors:
            raise RuntimeError(f"unprepare failed: {errors}")

    def cycle(self, tag, configs=None, devices=None, breakdown=None,
              server_ms=None, wire_ms=None, transport=None):
        """One full wire-level prepare->unprepare cycle; returns the
        prepare latency in ms. `wire_ms` collects the server-side wire
        stage breakdown ({decode,queue,encode,handler} ms)."""
        obj = _make_claim(self.cluster, self.gpus,
                          f"bench-{tag}-{uuid.uuid4().hex[:6]}",
                          configs=configs, devices=devices)
        t0 = time.perf_counter()
        self.prepare(obj, transport=transport)
        lat = (time.perf_counter() - t0) * 1e3
        if breakdown is not None:
            for k, v in self.state.last_prepare_breakdown.items():
                breakdown.setdefault(k, []).append(v)
        if server_ms is not None:
            server_ms.append(self.driver.last_prepare_ms)
        if wire_ms is not None:
            for k, v in self.driver.last_wire_breakdown.items():
                wire_ms.setdefault(k, []).append(v)
        self.unprepare([obj], transport=transport)
        return lat

    def config_p50(self, tag, n, configs=None, devices=None,
                   transport=None):
        """Median prepare latency over n cycles of one allocation config."""
        return statistics.median(
            self.cycle(f"{tag}-{i}", configs=configs, devices=devices,
                       transport=transport) for i in range(n))

    def ping_ms(self, n):
        """Round-trip ms of `n` framed pings: the socket and event loop
        alone, with no executor hop and no handler."""
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            if not self.framed_client.ping():
                raise RuntimeError("the framed socket did not answer a ping")
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def batch_cycle(self, tag, n_claims, breakdown=None):
        """One NodePrepareResources RPC carrying n_claims single-GPU
        claims on DISTINCT GPUs; returns per-claim ms."""
        from tpu_dra_torch.kubeletplugin import wire

        if n_claims > len(self.gpus):
            raise ValueError(
                f"batch of {n_claims} exclusive claims needs that many "
                f"GPUs (have {len(self.gpus)})")
        objs = [_make_claim(self.cluster, [self.gpus[i]],
                            f"bench-{tag}-{i}-{uuid.uuid4().hex[:6]}")
                for i in range(n_claims)]
        prepare, _ = self.stubs()
        t0 = time.perf_counter()
        resp = prepare(wire.NodePrepareResourcesRequest(
            claims=self._request(objs)))
        lat = (time.perf_counter() - t0) * 1e3
        if breakdown is not None:
            for k, v in self.state.last_batch_breakdown.items():
                breakdown.setdefault(k, []).append(v)
        try:
            errors = {u: r.error for u, r in resp.claims.items() if r.error}
            if errors:
                raise RuntimeError(f"batch prepare failed: {errors}")
        finally:
            # Unprepare whatever DID prepare even when one claim errored:
            # leaked prepared claims would dirty every later phase.
            self.unprepare(objs)
        return lat / n_claims

    def hot_restart(self):
        """Hot plugin restart on the SAME plugin and checkpoint dirs:
        drain the pipeline, run the journal barrier, take the old
        incarnation's sockets down, then bring up a fresh
        CheckpointManager/DeviceState/GpuDriver whose recovery replays
        the journal. Returns (drain_s, recovered_claims). Clients on
        RetryingFramedClient mask the socket gap."""
        if self.channel is not None:
            self.channel.close()
        self.framed_client.close()
        drain_s = self.driver.shutdown(drain=True)
        self._start()
        return drain_s, len(self.state.prepared_claim_uids())

    def release_prepared(self):
        """Unprepare every claim still prepared (a run that failed
        midway), so that no daemon, MIG instance or compute mode it set
        outlives the bench. Errors are logged: the run's own is raised."""
        for uid in self.state.prepared_claim_uids():
            err = self.state.unprepare(uid)
            if err:
                log.warning("unprepare of %s after a failed run: %s", uid,
                            err)

    def close(self):
        if self.channel is not None:
            self.channel.close()
        self.framed_client.close()
        self.driver.shutdown()
        if self.mps_sim is not None:
            self.mps_sim.stop()
        if self.mps_root is not None:
            shutil.rmtree(self.mps_root, ignore_errors=True)
        shutil.rmtree(self.tmp, ignore_errors=True)


def bench_claim_to_ready(backend, n_cycles: int = 100, warmup: int = 15,
                         scratch=None) -> dict:
    """Claim-to-ready of the kubelet plugin on `backend`'s GPUs: the
    NodePrepareResources round trip over the framed socket, as kubelet
    would make it, from an allocated ResourceClaim in a FakeCluster to
    the response naming its CDI devices. `warmup` cycles are discarded
    (lazy imports, channel set-up, first-touch page faults), then
    p50/p10/p95/IQR over `n_cycles` cycles claiming every GPU, and the
    breakdown of the p50: DeviceState's phases (prepare_breakdown_*),
    the driver around them (claim fetch, flock), and the wire (request
    decode, pipeline queue, response encode, and the transport, what
    the client clock sees beyond the handler), with a framed ping's
    round trip beside it (claim_to_ready_ping_p50_ms).

    Beside it: a one-GPU claim over the framed socket and over gRPC (the
    gRPC key is None, with the failed import in
    ``claim_to_ready_grpc_unavailable``, where ``grpc`` does not import),
    a time-sliced claim (None, with its error in
    ``claim_to_ready_timeslice_unavailable``, where the backend refuses
    the time slice: nvidia-smi needs root), the per-claim cost of a batch
    of up to 4 claims in one RPC (None on a one-GPU node: exclusive
    claims need distinct GPUs), and the MIG analog of the reference's
    subslice key: a claim of the first MIG device, None with the reason
    where no GPU is in MIG mode. The reference's key names;
    n_gpus and visible_gpus stand for its n_chips and visible_chips."""
    from tpu_dra_torch.api.types import API_VERSION, GPU_DRIVER_NAME
    from tpu_dra_torch.infra import featuregates

    bd = _BenchDriver(backend, scratch=scratch)
    gpus = bd.gpus
    try:
        for i in range(warmup):
            bd.cycle(f"warm-{i}")
        lat_ms: list = []
        phase_ms: dict = {}
        srv_ms: list = []
        wire_ms: dict = {}
        for i in range(n_cycles):
            lat_ms.append(bd.cycle(str(i), breakdown=phase_ms,
                                   server_ms=srv_ms, wire_ms=wire_ms))
        ping_ms = sorted(bd.ping_ms(n_cycles))
        n_config = max(3, n_cycles // 3)
        # Snapshot-and-restore: reset() would wipe gate overrides the
        # embedding process set before calling this.
        gates_before = featuregates.Features.overrides_snapshot()
        featuregates.Features.set_from_string("TimeSlicingSettings=true")
        ts_cfg = [{"source": "FromClaim", "requests": [], "opaque": {
            "driver": GPU_DRIVER_NAME, "parameters": {
                "apiVersion": API_VERSION, "kind": "GpuConfig",
                "sharing": {"strategy": "TimeSlicing",
                            "timeSlicingConfig": {"interval": "Short"}},
            }}}]
        ts_unavailable = None
        try:
            p50_ts = bd.config_p50("ts", n_config, configs=ts_cfg)
        except RuntimeError as e:
            p50_ts, ts_unavailable = None, str(e)
        finally:
            featuregates.Features.restore_overrides(gates_before)
        # The subslice key's analog: a MIG device's claim (its instance
        # created and destroyed each cycle), where a GPU is in MIG mode.
        mig = sorted(name for name, dev in bd.state.allocatable.items()
                     if dev.mig is not None)
        p50_mig, mig_unavailable = None, "no GPU of this node is in MIG mode"
        if mig:
            p50_mig, mig_unavailable = bd.config_p50(
                "mig", n_config, devices=mig[:1]), None
        batch_n = min(4, len(gpus))
        n_batch_cycles = max(5, n_cycles // 5)
        one_gpu = [f"gpu-{gpus[0]}"]
        p50_one = bd.config_p50("one", n_batch_cycles, devices=one_gpu)
        p50_one_grpc = (bd.config_p50("one-grpc", n_batch_cycles,
                                      devices=one_gpu, transport="grpc")
                        if bd.grpc_unavailable is None else None)
        batch_breakdown: dict = {}
        p50_batch = None
        if batch_n >= 2:
            p50_batch = statistics.median(
                bd.batch_cycle(f"b{i}", batch_n, breakdown=batch_breakdown)
                for i in range(n_batch_cycles))
        # One claim stays prepared to read the env its CDI spec hands
        # the container.
        obj = _make_claim(bd.cluster, gpus, "bench-final")
        res = bd.prepare(obj)
        env = bd.cdi.container_edits(res.devices[0].cdi_device_ids)["env"]
        bd.unprepare([obj])
        grpc_reason = bd.grpc_unavailable
    finally:
        bd.close()
    lat_ms.sort()
    p50 = statistics.median(lat_ms)
    srv_p50 = statistics.median(srv_ms)
    out = {
        "claim_to_ready_p50_ms": p50,
        "claim_to_ready_p10_ms": _pctl(lat_ms, 0.10),
        "claim_to_ready_p95_ms": _pctl(lat_ms, 0.95),
        "claim_to_ready_iqr_ms": _pctl(lat_ms, 0.75) - _pctl(lat_ms, 0.25),
        "claim_to_ready_cycles": len(lat_ms),
        # The framed socket's own round trip (a ping answered on the
        # event loop): the floor under prepare_breakdown_rpc_transport_ms.
        "claim_to_ready_ping_p50_ms": statistics.median(ping_ms),
        "claim_to_ready_warmup_cycles": warmup,
        "claim_to_ready_p50_timeslice_ms": p50_ts,
        "claim_to_ready_timeslice_unavailable": ts_unavailable,
        "claim_to_ready_p50_subslice_ms": p50_mig,
        "claim_to_ready_subslice_unavailable": mig_unavailable,
        "claim_to_ready_p50_1chip_ms": p50_one,
        "claim_to_ready_transport": "framed",
        "claim_to_ready_p50_1chip_grpc_ms": p50_one_grpc,
        "claim_to_ready_grpc_unavailable": grpc_reason,
        "claim_to_ready_batch_claims": (batch_n if p50_batch is not None
                                        else None),
        "claim_to_ready_p50_batch_per_claim_ms": p50_batch,
        "claim_to_ready_batch_amortization_x": (
            p50_one / p50_batch if p50_batch else None),
        "n_gpus": len(gpus),
        "visible_gpus": env.get("GPU_VISIBLE_INDICES", ""),
        "backend": backend.kind,
    }
    for k, vals in sorted(phase_ms.items()):
        out[f"prepare_breakdown_{k}_ms"] = statistics.median(vals)
    for k, vals in sorted(batch_breakdown.items()):
        if k != "n_claims":
            out[f"prepare_batch_breakdown_{k}_ms"] = statistics.median(vals)
    state_total = statistics.median(phase_ms.get("total", [0.0]))
    handler_p50 = statistics.median(wire_ms.get("handler", [srv_p50]))
    decode = statistics.median(wire_ms.get("decode", [0.0]))
    queue = statistics.median(wire_ms.get("queue", [0.0]))
    encode = statistics.median(wire_ms.get("encode", [0.0]))
    transport = max(p50 - handler_p50, 0.0)
    out["prepare_breakdown_rpc_decode_ms"] = decode
    out["prepare_breakdown_rpc_queue_ms"] = queue
    out["prepare_breakdown_rpc_encode_ms"] = encode
    out["prepare_breakdown_rpc_transport_ms"] = transport
    out["prepare_breakdown_rpc_wire_ms"] = transport + decode + queue + encode
    out["prepare_breakdown_driver_ms"] = max(
        handler_p50 - decode - queue - encode - state_total, 0.0)
    attributed = (state_total + out["prepare_breakdown_driver_ms"]
                  + out["prepare_breakdown_rpc_wire_ms"])
    out["prepare_attributed_pct"] = 100.0 * attributed / p50
    return out


# ---------------------------------------------------------------------------
# Hot restart: the plugin restarted under load, masked by the client
# ---------------------------------------------------------------------------

def bench_hot_restart(backend, duration_s: float = 12.0,
                      workers: int = 6, gpus_per_worker: int = 2,
                      n_restarts: int = 2, scratch=None) -> dict:
    """Hot plugin restart under sustained load: `workers` client threads
    on RetryingFramedClient prepare and unprepare their own claims
    flat-out while the kubelet plugin (a GpuDriver over `backend`) is
    restarted `n_restarts` times,
    spread evenly through `duration_s`: drain window (in-flight RPCs
    finish, new admissions refused), journal barrier, sockets down, a
    fresh driver recovering from the checkpoint journal on the SAME
    dirs. Worker w claims GPUs w*gpus_per_worker.. of the backend, modulo
    its GPU count (whole-GPU claims may share a GPU). The contract: ZERO
    failed RPCs, at least one reconnect per restart, zero leaked
    claims. Returns the reference's hot_restart_* keys."""
    from tpu_dra_torch.kubeletplugin import wire
    from tpu_dra_torch.kubeletplugin.server import (
        RPC_RECONNECTS, RetryingFramedClient,
    )

    bd = _BenchDriver(backend, scratch=scratch)
    fast_socket = bd.driver.server.fast_socket
    stop = threading.Event()
    lat_ms: list = []
    errors: list = []
    lat_lock = threading.Lock()
    reconnects0 = RPC_RECONNECTS.value()

    def worker(w):
        mine = [bd.gpus[(w * gpus_per_worker + j) % len(bd.gpus)]
                for j in range(gpus_per_worker)]
        reqs = []
        for j, g in enumerate(mine):
            obj = _make_claim(bd.cluster, [g], f"restart-{w}-{j}")
            claim = bd._request([obj])
            reqs.append((obj["metadata"]["uid"],
                         wire.NodePrepareResourcesRequest(claims=claim),
                         wire.NodeUnprepareResourcesRequest(claims=claim)))
        my_lats, my_errors = [], []
        client = RetryingFramedClient(fast_socket)
        try:
            i = 0
            while not stop.is_set():
                uid, req, ureq = reqs[i % len(reqs)]
                i += 1
                t0 = time.perf_counter()
                resp = client.prepare(req)
                my_lats.append((time.perf_counter() - t0) * 1e3)
                res = resp.claims.get(uid)
                if res is None or res.error:
                    my_errors.append(res.error if res else "no entry")
                t0 = time.perf_counter()
                uresp = client.unprepare(ureq)
                my_lats.append((time.perf_counter() - t0) * 1e3)
                ures = uresp.claims.get(uid)
                if ures is None or ures.error:
                    my_errors.append(ures.error if ures else "no entry")
        except Exception as e:  # noqa: BLE001 — every escape IS a
            my_errors.append(repr(e))  # failed RPC the contract counts
        finally:
            client.close()
        with lat_lock:
            lat_ms.extend(my_lats)
            errors.extend(my_errors)

    drain_s: list = []
    recovered: list = []
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # Reconnects counted from one restart's start to the next's (the
        # last: to the end of the run), so each restart is seen to be
        # masked by at least one redial of its own.
        marks = []
        for _ in range(n_restarts):
            time.sleep(duration_s / (n_restarts + 1))
            marks.append(RPC_RECONNECTS.value())
            d, r = bd.hot_restart()
            drain_s.append(d)
            recovered.append(r)
        time.sleep(duration_s / (n_restarts + 1))
        stop.set()
        for t in threads:
            t.join(60)
        wall_s = time.perf_counter() - t0
        marks.append(RPC_RECONNECTS.value())
        leaked = bd.state.prepared_claim_uids()
    finally:
        stop.set()
        bd.close()

    lat_ms.sort()
    out = {
        "hot_restart_restarts": n_restarts,
        "hot_restart_duration_s": wall_s,
        "hot_restart_workers": workers,
        "hot_restart_rpcs": len(lat_ms),
        "hot_restart_failed_rpcs": len(errors),
        "hot_restart_reconnects": int(RPC_RECONNECTS.value() - reconnects0),
        "hot_restart_reconnects_per_restart": [
            int(b - a) for a, b in zip(marks, marks[1:])],
        "hot_restart_drain_s_max": max(drain_s, default=0.0),
        "hot_restart_drain_s": drain_s,
        "hot_restart_recovered_claims": sum(recovered),
        "hot_restart_leaked_claims": len(leaked),
        "hot_restart_p50_ms": statistics.median(lat_ms) if lat_ms else None,
        "hot_restart_p99_ms": _pctl(lat_ms, 0.99) if lat_ms else None,
    }
    if errors:
        out["hot_restart_first_error"] = errors[0]
    return out


# ---------------------------------------------------------------------------
# Ops benches: the node driver on a fake inventory and under load, the
# scheduler's churn, topology and failover on fake GPU nodes, the tracer
# ---------------------------------------------------------------------------

def bench_fake_inventory_configs(n_cycles: int = 30,
                                 warmup: int = 5) -> dict:
    """BASELINE.json's MIG and MPS claim-to-ready configs, measured on a
    fake inventory whatever the host (counterpart of
    bench_fake_v5p_configs): the card's host has MIG off and refuses the
    compute mode MPS needs, so the node driver's own prepare of these
    configs is read on FakeBackend GPUs, beside a one-GPU p50 and a
    4-claim batch on the same driver and a 64-claim batch on a 64-GPU
    inventory. Each section is isolated: a failing one reports its
    ``*_error`` key and the others still report.

    - MIG (the reference's subslice): 4 fake H100s, GPU 0 in MIG mode;
      a claim of the first MIG device ``state.allocatable`` lists, its
      instance created and destroyed each cycle (as bench_claim_to_ready
      picks it).
    - MPS (the reference's multiprocess): a GpuConfig with the MPS
      strategy. Prepare blocks on the claim's control-daemon Deployment;
      a reactor marks the Deployment ready at create (a healthy kubelet
      minus the pod's start), and ``MpsControlDaemon.assert_ready`` reads
      only that field, so the number isolates the driver's prepare. The
      ``sharing`` phase's median is reported beside it.

    Key names are the reference's with ``fake_v5p`` read as
    ``fake_h100`` and ``subslice`` standing for MIG; "chip" in a key
    counts GPUs."""
    from tpu_dra_torch.api.types import API_VERSION, GPU_DRIVER_NAME
    from tpu_dra_torch.infra import featuregates
    from tpu_dra_torch.k8s import DEPLOYMENTS, FakeCluster

    cluster = FakeCluster()

    def make_ready(verb, gvr, obj):
        if verb == "create" and gvr.key == DEPLOYMENTS.key and obj:
            obj.setdefault("status", {})["readyReplicas"] = 1
        return obj

    cluster.reactors.append(make_ready)
    bd = bd64 = None
    out: dict = {}
    gates_before = featuregates.Features.overrides_snapshot()
    try:
        gpus = gpuinfo.default_fake_gpus(4, clique_id="bench")
        gpus[0] = dataclasses.replace(gpus[0], mig_mode=True)
        bd = _BenchDriver(gpuinfo.FakeBackend(gpus), cluster=cluster,
                          multiprocess=True)
        try:
            mig = sorted(name for name, dev in bd.state.allocatable.items()
                         if dev.mig is not None)[:1]
            for i in range(warmup):
                bd.cycle(f"warm-{i}", devices=mig)
            out["claim_to_ready_p50_subslice_fake_h100_ms"] = \
                bd.config_p50("mig", n_cycles, devices=mig)
        except Exception as e:  # noqa: BLE001 — isolate the section
            out["fake_h100_subslice_error"] = str(e)

        try:
            featuregates.Features.set_from_string("MultiprocessSupport=true")
            mps_cfg = [{"source": "FromClaim", "requests": [], "opaque": {
                "driver": GPU_DRIVER_NAME, "parameters": {
                    "apiVersion": API_VERSION, "kind": "GpuConfig",
                    "sharing": {"strategy": "MPS", "mpsConfig": {
                        "defaultActiveThreadPercentage": 50,
                        "defaultPinnedDeviceMemoryLimit": "8Gi"}},
                }}}]
            mps_breakdown: dict = {}
            bd.cycle("mps-warm", configs=mps_cfg)
            mps_lats = [bd.cycle(f"mps-{i}", configs=mps_cfg,
                                 breakdown=mps_breakdown)
                        for i in range(n_cycles)]
            out["claim_to_ready_p50_multiprocess_ms"] = \
                statistics.median(mps_lats)
            # The Deployment interaction's share (create + assert_ready
            # against the instant-ready fake): the driver-only MPS
            # number is the p50 minus this.
            out["multiprocess_sharing_phase_ms"] = statistics.median(
                mps_breakdown.get("sharing", [0.0]))
        except Exception as e:  # noqa: BLE001 — isolate the section
            out["fake_h100_multiprocess_error"] = str(e)

        try:
            # A GPU out of MIG mode (the reference: its chip 0).
            out["claim_to_ready_p50_1chip_fake_h100_ms"] = bd.config_p50(
                "one", n_cycles, devices=[f"gpu-{bd.gpus[-1]}"])
            batch_breakdown: dict = {}
            bd.batch_cycle("bwarm", 4)
            out["claim_to_ready_p50_batch_per_claim_fake_h100_ms"] = \
                statistics.median(
                    bd.batch_cycle(f"b{i}", 4, breakdown=batch_breakdown)
                    for i in range(n_cycles))
            out["claim_to_ready_batch_claims_fake_h100"] = 4
            for k, vals in sorted(batch_breakdown.items()):
                if k != "n_claims":
                    out[f"prepare_batch_breakdown_{k}_fake_h100_ms"] = \
                        statistics.median(vals)
        except Exception as e:  # noqa: BLE001 — isolate the section
            out["fake_h100_batch_error"] = str(e)

        # One NodePrepareResources RPC carrying 64 exclusive one-GPU
        # claims (a node-filling multi-claim pod) on its own driver.
        try:
            bd64 = _BenchDriver(gpuinfo.FakeBackend(
                gpuinfo.default_fake_gpus(64, clique_id="bench64")))
            bd64.batch_cycle("warm", 64)
            b64_breakdown: dict = {}
            out["claim_to_ready_p50_batch64_per_claim_ms"] = \
                statistics.median(
                    bd64.batch_cycle(f"b64-{i}", 64, breakdown=b64_breakdown)
                    for i in range(max(10, n_cycles // 3)))
            out["claim_to_ready_batch64_claims"] = 64
            for k, vals in sorted(b64_breakdown.items()):
                if k != "n_claims":
                    out[f"prepare_batch64_breakdown_{k}_ms"] = \
                        statistics.median(vals)
        except Exception as e:  # noqa: BLE001 — isolate the section
            out["fake_h100_batch64_error"] = str(e)
        return out
    finally:
        featuregates.Features.restore_overrides(gates_before)
        for d in (bd, bd64):
            if d is not None:
                d.close()


def bench_prepare_sustained(duration_s: float = None, workers: int = None,
                            gpus_per_worker: int = 4) -> dict:
    """Sustained prepare/unprepare against one node driver (counterpart
    of bench.py's bench_prepare_sustained): `workers` client threads,
    each on its own framed connection (``FramedClient``, the ``wire``
    codec) and its own `gpus_per_worker` GPUs of a fake inventory, drive
    1/1/1/1/2/4-claim prepare -> unprepare RPCs flat out for
    `duration_s` seconds: the claim churn an inference fleet puts
    through a node, where p99 under load is the number. Claims are made
    once and reused (kubelet's re-admit shape). A 500 Hz sampler reads
    both in-flight gauges (the front end's and the pipeline's past
    admission); the journal's appends over its group syncs is the
    fdatasync coalescing. Defaults: TPU_DRA_BENCH_SUSTAINED_S (45 s) and
    TPU_DRA_BENCH_SUSTAINED_WORKERS (8). Returns the reference's
    prepare_sustained_* keys."""
    from tpu_dra_torch.kubeletplugin import aio_server, wire
    from tpu_dra_torch.kubeletplugin.pipeline import INFLIGHT_RPCS
    from tpu_dra_torch.kubeletplugin.server import FramedClient

    duration_s = duration_s if duration_s is not None else float(
        os.environ.get("TPU_DRA_BENCH_SUSTAINED_S", "45"))
    workers = workers if workers is not None else int(
        os.environ.get("TPU_DRA_BENCH_SUSTAINED_WORKERS", "8"))
    pattern = (1, 1, 1, 1, 2, 4)

    bd = _BenchDriver(gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(
        workers * gpus_per_worker, clique_id="sustained")))
    ck = bd.state._ckpt_mgr
    stop = threading.Event()
    single_ms: list = []    # one-claim prepare RPCs (claim-to-ready)
    all_ms: list = []       # every RPC (prepare + unprepare, all sizes)
    errors: list = []
    lat_lock = threading.Lock()

    def reqs_for(objs):
        claims = _BenchDriver._request(objs)
        return ([o["metadata"]["uid"] for o in objs],
                wire.NodePrepareResourcesRequest(claims=claims),
                wire.NodeUnprepareResourcesRequest(claims=claims))

    def failures(resp, uids):
        return [(resp.claims[u].error if u in resp.claims else "no entry")
                for u in uids
                if u not in resp.claims or resp.claims[u].error]

    def worker(w):
        mine = bd.gpus[w * gpus_per_worker:(w + 1) * gpus_per_worker]
        objs = [_make_claim(bd.cluster, [g], f"sust-{w}-{g}") for g in mine]
        work = {1: [reqs_for([o]) for o in objs],
                2: [reqs_for(objs[:2])],
                4: [reqs_for(objs[:4])]}
        my_single, my_all, my_errors = [], [], []
        client = FramedClient(bd.driver.server.fast_socket)
        try:
            i = 0
            while not stop.is_set():
                size = pattern[i % len(pattern)]
                uids, req, ureq = work[size][i % len(work[size])]
                i += 1
                t0 = time.perf_counter()
                resp = client.prepare(req)
                lat = (time.perf_counter() - t0) * 1e3
                my_all.append((lat, size))
                if size == 1:
                    my_single.append(lat)
                my_errors.extend(failures(resp, uids))
                t0 = time.perf_counter()
                uresp = client.unprepare(ureq)
                my_all.append(((time.perf_counter() - t0) * 1e3, size))
                my_errors.extend(failures(uresp, uids))
        except Exception as e:  # noqa: BLE001 — counted as an error
            my_errors.append(repr(e))
        finally:
            client.close()
        with lat_lock:
            single_ms.extend(my_single)
            all_ms.extend(my_all)
            errors.extend(my_errors)

    inflight_front: list = []
    inflight_pipe: list = []

    def sampler():
        while not stop.wait(0.002):
            inflight_front.append(aio_server.SUSTAINED_INFLIGHT.value())
            inflight_pipe.append(INFLIGHT_RPCS.value())

    lag_n0 = aio_server.RPC_LOOP_LAG.count
    lag_sum0 = aio_server.RPC_LOOP_LAG.total
    lag_buckets0 = aio_server.RPC_LOOP_LAG.bucket_counts()
    appends0, syncs0 = ck.journal_appends, ck.journal_group_syncs
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(workers)]
        sampler_t = threading.Thread(target=sampler, daemon=True)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        sampler_t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(60)
        wall_s = time.perf_counter() - t0
        sampler_t.join(2)
        leaked = bd.state.prepared_claim_uids()
    finally:
        stop.set()
        bd.close()

    appends = ck.journal_appends - appends0
    syncs = ck.journal_group_syncs - syncs0
    lag_n = aio_server.RPC_LOOP_LAG.count - lag_n0
    lag_sum = aio_server.RPC_LOOP_LAG.total - lag_sum0
    lats = sorted(lat for lat, _ in all_ms)
    single = sorted(single_ms)
    claims_done = sum(size for _, size in all_ms) // 2  # prepare+unprepare
    depth8 = (sum(1 for v in inflight_front if v >= 8)
              / len(inflight_front)) if inflight_front else 0.0
    out = {
        "prepare_sustained_duration_s": wall_s,
        "prepare_sustained_workers": workers,
        "prepare_sustained_batch_mix": ",".join(map(str, pattern)),
        "prepare_sustained_rpcs": len(lats),
        "prepare_sustained_rpcs_per_s": len(lats) / wall_s,
        "prepare_sustained_claims_per_s": claims_done / wall_s,
        "prepare_sustained_p50_ms": (statistics.median(lats)
                                     if lats else None),
        "prepare_sustained_p99_ms": _pctl(lats, 0.99) if lats else None,
        "prepare_sustained_single_p50_ms": (statistics.median(single)
                                            if single else None),
        "prepare_sustained_single_p99_ms": (_pctl(single, 0.99)
                                            if single else None),
        "prepare_sustained_errors": len(errors),
        "prepare_sustained_leaked_claims": len(leaked),
        "prepare_sustained_inflight_peak": int(max(inflight_front,
                                                   default=0)),
        "prepare_sustained_inflight_mean": (
            statistics.mean(inflight_front) if inflight_front else None),
        "prepare_sustained_pipeline_inflight_peak": int(
            max(inflight_pipe, default=0)),
        "prepare_sustained_depth8_pct": 100.0 * depth8,
        "prepare_sustained_journal_appends": int(appends),
        "prepare_sustained_journal_group_syncs": int(syncs),
        "prepare_sustained_coalesce_ratio": (appends / syncs
                                             if syncs else None),
        "prepare_sustained_loop_lag_mean_ms": (lag_sum / lag_n * 1e3
                                               if lag_n else None),
        # Phase-scoped: other drivers of this process tick the same
        # histogram while idle.
        "prepare_sustained_loop_lag_p99_ms": 1e3 * (
            aio_server.RPC_LOOP_LAG.percentile_since(lag_buckets0, 0.99)),
    }
    if errors:
        out["prepare_sustained_first_error"] = errors[0]
    return out


def _start_bind_watcher(cluster, stop):
    """Background watcher pushing (pod_name, t_bound) for every pod seen
    gaining spec.nodeName (shared by bench_sched_churn and
    bench_topology, so the binding rule cannot drift). The watch
    registers on the thread's first next(), so it can miss the very
    first bind: callers that fail on a missed event consult the
    cluster on a queue timeout."""
    import queue as queue_mod

    from tpu_dra_torch.k8s import PODS

    bound_q: "queue_mod.Queue" = queue_mod.Queue()
    seen = set()

    def watch_bindings():
        for ev, obj in cluster.watch(PODS, namespace="default", stop=stop):
            if ev in ("ADDED", "MODIFIED") and obj["spec"].get("nodeName"):
                name = obj["metadata"]["name"]
                if name not in seen:
                    seen.add(name)
                    bound_q.put((name, time.perf_counter()))

    watcher = threading.Thread(target=watch_bindings, daemon=True)
    watcher.start()
    return bound_q, watcher


def _start_hollow_fleet(cluster, node_names, n_watchers, stop):
    """Kubemark-style hollow-node watcher fleet: `n_watchers` threads,
    each holding a field-selector-scoped pod watch
    (spec.nodeName=<node>) the way a kubelet does. The fake's fan-out is
    topic-indexed, so a node-scoped watcher is never offered another
    node's bind events and the fleet's cost is per delivered event, not
    per watcher x event. Returns (threads, stats): one dict of
    events/bookmarks/errors counts per watcher, updated live."""
    from tpu_dra_torch.k8s import PODS

    stats = [{"events": 0, "bookmarks": 0, "errors": 0}
             for _ in range(n_watchers)]
    stride = max(1, len(node_names) // n_watchers)

    def hollow(i, node):
        st = stats[i]
        for ev, obj in cluster.watch(
                PODS, namespace="default", stop=stop,
                field_selector=f"spec.nodeName={node}"):
            if ev == "BOOKMARK":
                st["bookmarks"] += 1
            elif ev == "ERROR":
                st["errors"] += 1
                break
            else:
                st["events"] += 1

    threads = []
    for i in range(n_watchers):
        node = node_names[(i * stride) % len(node_names)]
        t = threading.Thread(target=hollow, args=(i, node), daemon=True,
                             name=f"hollow-{i}")
        t.start()
        threads.append(t)
    return threads, stats


def bench_sched_churn(n_nodes: int = None, n_pods: int = None,
                      gpus_per_node: int = 4, window: int = None,
                      workers: int = None,
                      hollow_watchers: int = 0) -> dict:
    """Control-plane churn (counterpart of bench.py's bench_sched_churn):
    `n_nodes` fake GPU nodes publishing ResourceSlices, `n_pods` pod
    lifecycles (create -> template claim -> allocate -> bind -> delete
    -> claim GC) through the event-driven Scheduler, `window` lifecycles
    in flight. Defaults: TPU_DRA_BENCH_SCHED_NODES (100) and
    TPU_DRA_BENCH_SCHED_PODS (500), 4 GPUs a node, a window of 64.
    Reports pod create -> bound p50/p95, throughput, the scheduler's full
    relists (0 in steady state), the CEL compiles against the distinct
    selector sources (the compile cache: compiles <= distinct), and
    ``sched_churn_gc_leak`` where a claim outlives its pod.

    `workers` sizes the scheduler's pool (None: its default,
    ``TPU_DRA_SCHED_WORKERS`` or 4), and ``sched_workers`` reports what
    the scheduler ran. `hollow_watchers` > 0 runs that many node-scoped
    pod watchers beside the churn (``_start_hollow_fleet``) and adds the
    ``sched_hollow_*`` keys: events delivered in all and to the busiest
    watcher, bookmarks, and watcher-queue overflows.
    ``sched_churn_chips_per_node`` keeps the reference's name and counts
    GPUs."""
    import queue as queue_mod

    from tpu_dra_torch.infra.metrics import (
        CEL_CACHE_HITS, CEL_CACHE_MISSES, CEL_COMPILES, SCHED_FULL_RELISTS,
        SCHED_SHARD_RESYNCS, SCHED_SNAPSHOT_CONFLICTS,
    )
    from tpu_dra_torch.k8s import PODS, RESOURCECLAIMS, FakeCluster
    from tpu_dra_torch.simcluster.scheduler import Scheduler
    from tpu_dra_torch.testing import (
        DEFAULT_SCHED_SELECTOR, make_sched_pod, seed_sched_inventory,
    )

    n_nodes = n_nodes if n_nodes is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCHED_NODES", "100"))
    n_pods = n_pods if n_pods is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCHED_PODS", "500"))
    cluster = FakeCluster()
    # Two selector expressions, so the CEL cache sees a conjunction per
    # allocation; each must compile once across the whole churn.
    exprs = [DEFAULT_SCHED_SELECTOR,
             'device.attributes["gpu.dev"].architecture == "hopper"']
    node_names = seed_sched_inventory(
        cluster, nodes=n_nodes, gpus_per_node=gpus_per_node,
        node_fmt="n{i:03d}", selector_exprs=exprs)
    capacity = n_nodes * gpus_per_node
    window = min(window or 64, max(1, capacity // 2), n_pods)

    relists0 = SCHED_FULL_RELISTS.value()
    conflicts0 = SCHED_SNAPSHOT_CONFLICTS.value()
    resyncs0 = SCHED_SHARD_RESYNCS.value()
    compiles0 = CEL_COMPILES.value()
    hits0, misses0 = CEL_CACHE_HITS.value(), CEL_CACHE_MISSES.value()

    # The sweep is pushed past the bench's horizon: the claim-GC drain
    # below must prove the event path, not the periodic safety net.
    sched = Scheduler(cluster, resync_interval=2.0, gc_sweep_interval=3600.0,
                      workers=workers)
    sched.start()
    stop = threading.Event()
    bound_q, _watcher = _start_bind_watcher(cluster, stop)
    hollow_stats = []
    if hollow_watchers:
        _hollow_threads, hollow_stats = _start_hollow_fleet(
            cluster, node_names, hollow_watchers, stop)
    t_created: dict = {}
    lat_ms = []

    def make_pod(i):
        name = f"churn-{i:05d}"
        t_created[name] = time.perf_counter()
        make_sched_pod(cluster, name)

    try:
        t0 = time.perf_counter()
        created = 0
        for _ in range(window):
            make_pod(created)
            created += 1
        done = 0
        while done < n_pods:
            try:
                name, t_bound = bound_q.get(timeout=60)
            except queue_mod.Empty:
                raise RuntimeError(
                    f"churn: no pod bound in 60 s ({done} of {n_pods} done)")
            lat_ms.append((t_bound - t_created.pop(name)) * 1e3)
            done += 1
            cluster.delete(PODS, name, "default")  # frees its GPUs
            if created < n_pods:
                make_pod(created)
                created += 1
        wall_s = time.perf_counter() - t0
        # Drain: every template claim is GCed from its pod's delete event.
        gc_ok = cluster.wait_for(
            lambda: not cluster.list(RESOURCECLAIMS, namespace="default"),
            timeout=15)
    finally:
        stop.set()
        sched.stop()

    lat_ms.sort()
    hits = CEL_CACHE_HITS.value() - hits0
    misses = CEL_CACHE_MISSES.value() - misses0
    out = {
        "sched_pod_to_allocated_p50_ms": statistics.median(lat_ms),
        "sched_pod_to_allocated_p95_ms": _pctl(lat_ms, 0.95),
        "sched_throughput_pods_per_s": n_pods / wall_s,
        "sched_full_relists": int(SCHED_FULL_RELISTS.value() - relists0),
        "sched_churn_nodes": n_nodes,
        "sched_churn_pods": n_pods,
        "sched_churn_chips_per_node": gpus_per_node,
        "sched_churn_window": window,
        "sched_workers": sched._workers,
        "sched_index_shards": sched._index.n_shards,
        "sched_snapshot_conflicts": int(
            SCHED_SNAPSHOT_CONFLICTS.value() - conflicts0),
        "sched_shard_resyncs": int(SCHED_SHARD_RESYNCS.value() - resyncs0),
        "sched_cel_compiles": int(CEL_COMPILES.value() - compiles0),
        "sched_cel_distinct_exprs": len(set(exprs)),
        "sched_cel_cache_hit_pct": (100.0 * hits / (hits + misses)
                                    if hits + misses else None),
    }
    if hollow_watchers:
        delivered = [st["events"] for st in hollow_stats]
        out["sched_hollow_watchers"] = hollow_watchers
        out["sched_hollow_events_total"] = sum(delivered)
        out["sched_hollow_events_max"] = max(delivered)
        out["sched_hollow_bookmarks"] = sum(
            st["bookmarks"] for st in hollow_stats)
        out["sched_hollow_overflow_errors"] = sum(
            st["errors"] for st in hollow_stats)
    if not gc_ok:
        out["sched_churn_gc_leak"] = len(
            cluster.list(RESOURCECLAIMS, namespace="default"))
    return out


def bench_sched_scale10k(n_nodes: int = None, n_pods: int = None,
                         n_watchers: int = None, gpus_per_node: int = 4,
                         baseline_nodes: int = None,
                         baseline_pods: int = None) -> dict:
    """Kubemark-style control-plane scale-out (counterpart of bench.py's
    bench_sched_scale10k): `n_nodes` fake GPU nodes and `n_pods` pod
    lifecycles through the scheduler's pool (partitioned claims informer,
    sharded watch fan-out), with a hollow-node fleet of `n_watchers`
    node-scoped pod watchers riding the stream as kubelets would. Sizes
    default from TPU_DRA_BENCH_SCALE10K_NODES / _PODS / _WATCHERS /
    _BASELINE_NODES / _BASELINE_PODS (10000 / 100000 / 100 / 1000 /
    5000). A same-process baseline churn of `baseline_nodes` x
    `baseline_pods` runs first, so the ratio compares like with like.
    Reports bench_sched_churn's keys renamed sched_scale10k_*, the
    baseline's throughput and p50, and sched_scale10k_throughput_ratio
    (big pods/s over baseline pods/s; hack/perf.sh gates the
    reference's at >= 0.5)."""
    n_nodes = n_nodes if n_nodes is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCALE10K_NODES", "10000"))
    n_pods = n_pods if n_pods is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCALE10K_PODS", "100000"))
    n_watchers = n_watchers if n_watchers is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCALE10K_WATCHERS", "100"))
    baseline_nodes = baseline_nodes if baseline_nodes is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCALE10K_BASELINE_NODES", "1000"))
    baseline_pods = baseline_pods if baseline_pods is not None else int(
        os.environ.get("TPU_DRA_BENCH_SCALE10K_BASELINE_PODS", "5000"))

    base = bench_sched_churn(n_nodes=baseline_nodes, n_pods=baseline_pods,
                             gpus_per_node=gpus_per_node)
    big = bench_sched_churn(n_nodes=n_nodes, n_pods=n_pods,
                            gpus_per_node=gpus_per_node,
                            hollow_watchers=n_watchers)
    out = {k.replace("sched_", "sched_scale10k_", 1): v
           for k, v in big.items()}
    base_pps = base["sched_throughput_pods_per_s"]
    out["sched_scale10k_baseline_nodes"] = baseline_nodes
    out["sched_scale10k_baseline_pods"] = baseline_pods
    out["sched_scale10k_baseline_throughput_pods_per_s"] = base_pps
    out["sched_scale10k_baseline_pod_to_allocated_p50_ms"] = base[
        "sched_pod_to_allocated_p50_ms"]
    out["sched_scale10k_throughput_ratio"] = (
        big["sched_throughput_pods_per_s"] / base_pps if base_pps else None)
    return out


def bench_chaos_recovery(n: int = 7, backend=None) -> dict:
    """Chaos-recovery latency (counterpart of bench.py's
    bench_chaos_recovery): median and p95 wall ms from an injected
    plugin crash (unclean teardown, nothing unprepared) to the affected
    claim prepared again — checkpoint load + orphan GC + CDI spec
    rewrite + DRA server up + idempotent re-prepare — over `n` crashes.
    `backend` is the node's inventory (NVML on the card); by default the
    chaos harness's fake node."""
    from tpu_dra_torch.simcluster.chaos import measure_daemon_crash_recovery

    return measure_daemon_crash_recovery(n, backend=backend)


TOPO_NODES = 8          # HGX H100 nodes of the topology bench
TOPO_GPUS_PER_NODE = 8


def _largest_free_clique_block(topos, claims) -> int:
    """The largest free contiguous block (GPUs) of any node's NVLink
    clique: `topos` maps each node to its NodeTopology, `claims` are the
    cluster's ResourceClaims."""
    from tpu_dra_torch.simcluster.scheduler import claim_entries
    from tpu_dra_torch.topology import placement

    taken: dict = {}
    for claim in claims:
        for _driver, pool, dev in claim_entries(claim):
            taken.setdefault(pool, set()).add(dev)
    return max((placement.max_free_cuboid(topo.fabric, {
        c for name, c in topo.coord_of.items()
        if name not in taken.get(node, ())}) for node, topo in topos.items()),
        default=0)


def _spans_cliques(claims, pod: str, topos) -> bool:
    """Whether `pod`'s allocated claim holds devices of more than one
    node or NVLink clique."""
    from tpu_dra_torch.simcluster.scheduler import claim_entries

    for claim in claims:
        if (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod") == pod:
            return len({(pool, topos[pool].clique_id)
                        for _driver, pool, _dev in claim_entries(claim)}) > 1
    return False


def bench_topology(n_pods: int = 120, seed: int = 7) -> dict:
    """Fragmentation under churn (counterpart of bench.py's
    bench_topology): alloc/free of mixed 1/2/4/8-GPU pods, seeded, through
    the event-driven Scheduler with the TopologyAwareScheduling gate on,
    at most 48 of the 64 GPUs held at once.

    The inventory differs from the reference's one 64-chip 4x4x4 torus
    node (no GPU node holds 64 devices): 64 GPUs as TOPO_NODES fake HGX
    H100 nodes of TOPO_GPUS_PER_NODE GPUs, one NVLink clique per node
    (``topo_mesh`` reads "8x(8x1x1)"). Reports:

    - topo_contiguity_ratio: topology-scored picks over all multi-GPU
      picks; a pick counts as contiguous when the placement scoring made
      it and every device of it lies on one node in one clique (a placed
      claim that spans cliques counts as a fallback);
    - topo_place_p50_ms / p95: pod create -> bound;
    - topo_score_mean_ms: the placement scan and score alone;
    - topo_free_cuboid_p50_chips (the reference's name): the median,
      over placements, of the largest free clique block left on any node
      after the placement — the fragmentation observable.
    """
    import queue as queue_mod
    import random

    from tpu_dra_torch.infra import featuregates
    from tpu_dra_torch.infra.metrics import TOPO_ALLOCS, TOPO_SCORE_SECONDS
    from tpu_dra_torch.k8s import (
        PODS, RESOURCECLAIMS, RESOURCESLICES, FakeCluster,
    )
    from tpu_dra_torch.simcluster.scheduler import Scheduler
    from tpu_dra_torch.testing import make_sched_pod, seed_sched_inventory
    from tpu_dra_torch.topology import placement

    gates_before = featuregates.Features.overrides_snapshot()
    featuregates.Features.set_from_string("TopologyAwareScheduling=true")
    sched = None
    stop = threading.Event()
    rng = random.Random(seed)
    sizes = (1, 1, 2, 2, 4, 4, 8)
    lat_ms, free_blocks = [], []
    live: dict = {}   # name -> GPUs
    unplaced = split = 0
    cap = TOPO_NODES * TOPO_GPUS_PER_NODE * 3 // 4
    try:
        cluster = FakeCluster()
        seed_sched_inventory(cluster, nodes=TOPO_NODES,
                             gpus_per_node=TOPO_GPUS_PER_NODE,
                             node_fmt="hgx{i}", claim_counts=(2, 4, 8))
        topos = {sl["spec"]["nodeName"]:
                 placement.node_topology_from_slices([sl])
                 for sl in cluster.list(RESOURCESLICES)}
        labels = ("contiguous", "fallback", "unplaceable")
        topo0 = {k: TOPO_ALLOCS.value(labels={"outcome": k}) for k in labels}
        score_n0 = TOPO_SCORE_SECONDS.count
        score_sum0 = TOPO_SCORE_SECONDS.total

        sched = Scheduler(cluster, resync_interval=0.05,
                          gc_sweep_interval=3600.0)
        sched.start()
        bound_q, _watcher = _start_bind_watcher(cluster, stop)

        for i in range(n_pods):
            n = rng.choice(sizes)
            # Free enough before each create that a contiguous block for
            # n plausibly exists (the cap keeps the walk fragmenting
            # without deadlocking).
            while sum(live.values()) + n > cap:
                victim = rng.choice(sorted(live))
                cluster.delete(PODS, victim, "default")
                live.pop(victim)
            name = f"topo-{i:04d}"
            t0 = time.perf_counter()
            make_sched_pod(cluster, name,
                           template="tmpl" if n == 1 else f"tmpl{n}")
            live[name] = n
            try:
                while True:
                    bound, t1 = bound_q.get(timeout=15)
                    if bound == name:
                        break
                lat_ms.append((t1 - t0) * 1e3)
            except queue_mod.Empty:
                # The very first bind can slip past the watch: consult
                # the cluster before counting a wedge.
                if cluster.get(PODS, name,
                               "default")["spec"].get("nodeName"):
                    lat_ms.append((time.perf_counter() - t0) * 1e3)
                else:
                    # A fragmentation wedge: count it, free the pod, keep
                    # churning (nothing was allocated).
                    unplaced += 1
                    cluster.delete(PODS, name, "default")
                    live.pop(name)
                    continue
            claims = cluster.list(RESOURCECLAIMS)
            free_blocks.append(_largest_free_clique_block(topos, claims))
            if n > 1:
                split += _spans_cliques(claims, name, topos)
        for name in sorted(live):
            cluster.delete(PODS, name, "default")
        cluster.wait_for(
            lambda: not cluster.list(RESOURCECLAIMS, namespace="default"),
            timeout=15)
    finally:
        stop.set()
        if sched is not None:
            sched.stop()
        featuregates.Features.restore_overrides(gates_before)

    delta = {k: TOPO_ALLOCS.value(labels={"outcome": k}) - topo0[k]
             for k in topo0}
    contig = delta["contiguous"] - split
    fallback = delta["fallback"] + split
    score_n = TOPO_SCORE_SECONDS.count - score_n0
    score_ms = ((TOPO_SCORE_SECONDS.total - score_sum0) / score_n * 1e3
                if score_n else None)
    lat_ms.sort()
    return {
        "topo_contiguity_ratio": (contig / (contig + fallback)
                                  if contig + fallback else None),
        "topo_place_p50_ms": statistics.median(lat_ms),
        "topo_place_p95_ms": _pctl(lat_ms, 0.95),
        "topo_alloc_contiguous": int(contig),
        "topo_alloc_fallback": int(fallback),
        "topo_alloc_unplaceable_attempts": int(delta["unplaceable"]),
        "topo_unplaced_pods": unplaced,
        "topo_score_mean_ms": score_ms,
        "topo_free_cuboid_p50_chips": (statistics.median_low(free_blocks)
                                       if free_blocks else None),
        "topo_churn_pods": len(lat_ms),
        "topo_mesh": f"{TOPO_NODES}x({TOPO_GPUS_PER_NODE}x1x1)",
    }


def bench_sched_failover(n_failovers: int = None, n_nodes: int = 12,
                         gpus_per_node: int = 2, window: int = 8) -> dict:
    """Scheduler failover under churn (counterpart of bench.py's
    bench_sched_failover): two Schedulers started standby behind
    LeaderElectors over one fenced Lease (0.4 s lease, 0.1 s renew), pod
    churn running throughout (`window` pods live). Each round kills the
    acting leader cold (no lease release: the standby must wait out the
    expiry) and times the kill -> the standby's first new allocation:
    expiry, takeover CAS, the index's full resync, the first commit.
    Rounds: TPU_DRA_BENCH_FAILOVER_N (5).

    The standby's allocations are told by their fencing stamp (a
    generation above the killed leader's). The reference counts any
    claim allocated after the kill, which includes the dying leader's
    own commits while its workers stop, so it can read less than the
    lease it must wait out."""
    from tpu_dra_torch.infra.leaderelect import (
        FENCING_ANNOTATION, LeaderElector, install_fencing,
    )
    from tpu_dra_torch.k8s import PODS, RESOURCECLAIMS, FakeCluster
    from tpu_dra_torch.simcluster.scheduler import Scheduler
    from tpu_dra_torch.testing import make_sched_pod, seed_sched_inventory

    n_failovers = n_failovers if n_failovers is not None else int(
        os.environ.get("TPU_DRA_BENCH_FAILOVER_N", "5"))
    lease_duration_s = 0.4

    lat_ms = []
    for round_i in range(n_failovers):
        cluster = FakeCluster()
        install_fencing(cluster)
        seed_sched_inventory(cluster, nodes=n_nodes,
                             gpus_per_node=gpus_per_node,
                             node_fmt="n{i:03d}")
        scheds, electors = [], []
        for ident in ("sched-a", "sched-b"):
            sched = Scheduler(cluster, gc_sweep_interval=3600.0)
            sched.start(standby=True)

            def on_started(gen, s=sched):
                s.set_lease_generation(gen)
                s.promote()

            electors.append(LeaderElector(
                cluster, ident, lease_duration_s=lease_duration_s,
                renew_interval_s=0.1, on_started_leading=on_started,
                seed=round_i))
            scheds.append(sched)
        stop = threading.Event()

        def churn(round_i=round_i, cluster=cluster, stop=stop):
            i = 0
            while not stop.is_set():
                pods = cluster.list(PODS, namespace="default")
                for pod in pods:
                    if pod["spec"].get("nodeName"):
                        cluster.delete(PODS, pod["metadata"]["name"],
                                       "default")
                for _ in range(max(0, window - len(pods))):
                    make_sched_pod(cluster, f"fo-{round_i}-{i:05d}")
                    i += 1
                stop.wait(0.005)

        def allocated_uids(cluster=cluster, above=0):
            """Allocated claims stamped with a generation above `above`."""
            return {c["metadata"]["uid"]
                    for c in cluster.list(RESOURCECLAIMS,
                                          namespace="default")
                    if (c.get("status") or {}).get("allocation")
                    and int((c["metadata"].get("annotations") or {}).get(
                        FENCING_ANNOTATION, 0)) > above}

        churn_t = threading.Thread(target=churn, daemon=True)
        try:
            # The leader first, acting, then the standby.
            electors[0].start()
            deadline = time.monotonic() + 10.0
            while not electors[0].is_leader \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            electors[1].start()
            churn_t.start()
            deadline = time.monotonic() + 30.0
            while not allocated_uids() and time.monotonic() < deadline:
                time.sleep(0.005)
            if not allocated_uids():
                raise RuntimeError("leader never allocated under churn")
            # Kill the leader cold: elector gone (no release), workers
            # gone. The standby must see the expiry, take over, resync
            # and commit.
            killed = electors[0].generation
            t_kill = time.perf_counter()
            electors[0].stop()
            scheds[0].stop()
            deadline = time.monotonic() + 30.0
            t_first = None
            while time.monotonic() < deadline:
                if allocated_uids(above=killed):
                    t_first = time.perf_counter()
                    break
                time.sleep(0.002)
            if t_first is None:
                raise RuntimeError(
                    "standby never allocated after leader kill")
            lat_ms.append((t_first - t_kill) * 1e3)
        finally:
            stop.set()
            if churn_t.is_alive():
                churn_t.join(5)
            for el in electors:
                el.stop()
            for sched in scheds:
                sched.stop()

    lat_ms.sort()
    return {
        "sched_failover_rounds": n_failovers,
        "sched_failover_lease_duration_s": lease_duration_s,
        "sched_failover_nodes": n_nodes,
        "sched_failover_to_alloc_p50_ms": statistics.median(lat_ms),
        "sched_failover_to_alloc_max_ms": max(lat_ms),
    }


def bench_trace_overhead(n_spans: int = 200_000) -> dict:
    """Tracer cost (counterpart of bench.py's bench_trace_overhead): ns
    per begin/end pair with emission on (ids, open-span tracking, ring
    append) and off (timestamps only), and the spans/s the enabled path
    delivers. The tracer's enabled state is restored."""
    from tpu_dra_torch.infra.trace import TRACER

    def spin(n):
        t0 = time.perf_counter()
        for _ in range(n):
            span = TRACER.begin("bench.overhead", root=True)
            span.end()
        return time.perf_counter() - t0

    was_enabled = TRACER.enabled
    TRACER.set_enabled(True)
    try:
        spin(n_spans // 10)  # warm (allocator, ring steady state)
        wall_on = spin(n_spans)
        TRACER.set_enabled(False)
        spin(n_spans // 10)
        wall_off = spin(n_spans)
    finally:
        TRACER.set_enabled(was_enabled)
    return {
        "trace_overhead_ns_per_span": wall_on / n_spans * 1e9,
        "trace_overhead_off_ns_per_span": wall_off / n_spans * 1e9,
        "trace_spans_per_s": int(n_spans / wall_on),
        "trace_overhead_spans": n_spans,
    }


def ops_benches(sustained_s: float = None):
    """Yield (name, record) for each ops bench at its default size, as
    each finishes; every record carries its ``phase_s`` and the host's
    ``os.cpu_count()`` (the reference's rate gates scale with it).
    `sustained_s` overrides bench_prepare_sustained's duration."""
    runs = [
        ("fake_inventory", bench_fake_inventory_configs),
        ("prepare_sustained",
         lambda: bench_prepare_sustained(duration_s=sustained_s)),
        ("sched_churn", bench_sched_churn),
        ("topology", bench_topology),
        ("sched_failover", bench_sched_failover),
        ("trace_overhead", bench_trace_overhead),
    ]
    for name, fn in runs:
        t0 = time.perf_counter()
        rec = fn()
        rec["phase_s"] = time.perf_counter() - t0
        rec["cpu_count"] = os.cpu_count()
        yield name, rec


# ---------------------------------------------------------------------------
# Shared claims: one claim, several train-step tenants at once
# ---------------------------------------------------------------------------

MPS_NAMESPACE = "gpu-dra-driver"
SHARED_STEPS = 10
CLAIM_CHILD = "claim-child"
GO = "go"
N_TENANTS = 2
# Each tenant's timed window must overlap every other's for at least this
# share of its own length, or the tenants did not share the device. CPU
# tenants (the CPU tier's) share no device: each has cores of its own, so
# their windows differ by those cores' speed, and only half is asked.
MIN_OVERLAP = 0.9
MIN_OVERLAP_CPU = 0.5
TENANT_TIMEOUT_S = 900.0


class _TenantBarrier:
    """claim_child's barrier before the timed steps: with `wait_go`,
    print {"ready": pid} and wait for the parent's "go" line; then zero
    the launch counts. A class, not a closure, so that the spawned ranks
    of a multi-GPU claim receive it pickled."""

    def __init__(self, wait_go: bool):
        self.wait_go = wait_go

    def __call__(self) -> None:
        from tpu_dra_torch.workloads import _cuda

        if self.wait_go:
            print(json.dumps({"ready": os.getpid()}), flush=True)
            line = sys.stdin.readline().strip()
            if line != GO:
                raise RuntimeError(f"tenant waited for {GO!r}, read {line!r}")
        _cuda.reset_launches()


def claim_child(argv) -> int:
    """A tenant of a claim (``python -m tpu_dra_torch.bench claim-child``):
    plan_from_env -> devices_from_env -> launch_workload("train") on this
    process's environment, the flagship at full width unless ``--config``
    (ModelConfig fields as JSON, dtype by name) says otherwise.
    Where the env also holds a ComputeDomain channel claim's (NODE_RANK),
    the claim's GPUs are this node's ranks of the domain, whose group
    starts at the env's MASTER_ADDR:MASTER_PORT.
    ``--warm N`` untimed steps come first; with ``--wait-go``
    it then prints ``{"ready": pid}`` and waits for a "go" line on stdin,
    so that several tenants time their steps together. The launch counts
    are zeroed just before the ``--steps N`` timed steps. Prints one JSON
    line: the workload's record (losses, step times, host-clock window),
    the UUID of the device it ran on, the claim's UUIDs, the launch
    counts and, on a card, the allocator's peak and mem_get_info."""
    import argparse

    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import _cuda
    from tpu_dra_torch.workloads import meshbuild

    ap = argparse.ArgumentParser(prog=CLAIM_CHILD)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warm", type=int, default=0)
    ap.add_argument("--wait-go", action="store_true")
    ap.add_argument("--device-type", default="cuda")
    ap.add_argument("--config", default=None)
    args = ap.parse_args(argv)
    env = dict(os.environ)
    domain = env if "NODE_RANK" in env else None
    plan = plan_from_env(env)
    devices = meshbuild.devices_from_env(env, args.device_type)
    cfg = FLAGSHIP
    if args.config:
        fields = json.loads(args.config)
        fields["dtype"] = getattr(torch, fields.get("dtype", "bfloat16"))
        cfg = ModelConfig(**fields)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab,
                                              (FLAGSHIP_BATCH, cfg.max_seq))

    res = meshbuild.launch_workload("train", plan, devices, domain=domain,
                                    cfg=cfg, steps=args.steps,
                                    tokens=tokens, warm_steps=args.warm,
                                    barrier=_TenantBarrier(args.wait_go))
    device = torch.device(res["device"])
    out = {**res, "pid": os.getpid(),
           "claim_uuids": env.get("CUDA_VISIBLE_DEVICES", "").split(","),
           "uuid": None, "max_memory_allocated": None, "mem_get_info": None,
           "plan": {"coords": plan.coords, "topology": plan.fabric_dims,
                    "generation": plan.generation},
           "launches": _cuda.launches()}
    if device.type == "cuda":
        out["uuid"] = str(torch.cuda.get_device_properties(device).uuid)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        out["mem_get_info"] = list(torch.cuda.mem_get_info(device))
    print(json.dumps(out), flush=True)
    return 0


def runtime_env(edits: dict) -> tuple:
    """A claim's CDI env as a host process must see it: a container
    runtime would bind each mount's hostPath at its containerPath, so an
    env value under a containerPath is rewritten to the hostPath.
    Returns (env, [(name, container value, host value)])."""
    env = dict(edits["env"])
    rewritten = []
    for mount in edits.get("mounts", []):
        cpath, hpath = mount["containerPath"], mount["hostPath"]
        if cpath == hpath:
            continue
        for key, value in env.items():
            if value == cpath or value.startswith(cpath + "/"):
                env[key] = hpath + value[len(cpath):]
                rewritten.append((key, value, env[key]))
    return env, rewritten


def mps_clients(pipe_dir: str, control=None) -> dict:
    """Server pid -> client pids, as the MPS control daemon whose pipe
    directory is `pipe_dir` answers get_server_list and then
    get_client_list for each server."""
    from tpu_dra_torch.gpuplugin.sharing import ENV_MPS_PIPE, MPS_CONTROL

    control = list(control or [MPS_CONTROL])
    env = {**os.environ, ENV_MPS_PIPE: pipe_dir}

    def ask(command: str) -> list:
        proc = subprocess.run(control, input=command + "\n", env=env,
                              capture_output=True, text=True, timeout=30)
        if proc.returncode != 0:
            raise RuntimeError(f"{command!r} to the MPS control daemon: "
                               f"exit {proc.returncode} {proc.stderr!r}")
        return [int(t) for t in proc.stdout.split() if t.isdigit()]

    return {pid: ask(f"get_client_list {pid}")
            for pid in ask("get_server_list")}


def _run_tenants(argv, env, n, cwd, pipe_dir=None, control=None) -> tuple:
    """`n` tenants of one claim at once: each runs `argv` (a claim child
    with --wait-go) under `env`; once every one has taken its warm step
    and is waiting, all get "go" together. With `pipe_dir`, the MPS
    control daemon is asked for its clients until the tenants exit.
    Returns (each tenant's record, the most MPS clients seen at once)."""
    errs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = [subprocess.Popen(argv, env=env, cwd=cwd, stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, stderr=err, text=True)
             for err in errs]
    killer = threading.Timer(TENANT_TIMEOUT_S,
                             lambda: [p.kill() for p in procs])
    killer.start()

    def failed(i, what):
        errs[i].seek(0)
        return RuntimeError(f"tenant {i} (pid {procs[i].pid}) {what}; "
                            f"exit {procs[i].poll()}:\n{errs[i].read()[-4000:]}")

    try:
        for i, p in enumerate(procs):
            line = p.stdout.readline()
            while line and not line.startswith('{"ready"'):
                line = p.stdout.readline()
            if not line:
                raise failed(i, "did not get ready")
        for p in procs:
            p.stdin.write(GO + "\n")
            p.stdin.flush()
        clients = 0
        while pipe_dir is not None and any(p.poll() is None for p in procs):
            seen = mps_clients(pipe_dir, control)
            clients = max(clients, sum(len(c) for c in seen.values()))
            time.sleep(0.05)
        out = []
        for i, p in enumerate(procs):
            lines = p.stdout.read().strip().splitlines()
            if p.wait() != 0 or not lines:
                raise failed(i, "failed")
            out.append(json.loads(lines[-1]))
        return out, clients
    finally:
        killer.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for err in errs:
            err.close()


def _tenant_reading(rec: dict) -> dict:
    median = statistics.median(rec["step_times_s"])
    return {"pid": rec["pid"], "uuid": rec["uuid"],
            "median_step_s": median,
            "tokens_per_s": rec["batch"] * (rec["seq"] - 1) / median,
            "step_times_s": rec["step_times_s"], "window": rec["window"],
            "losses": rec["losses"],
            "max_memory_allocated": rec["max_memory_allocated"],
            "mem_get_info": rec["mem_get_info"],
            "n_layers": rec["n_layers"], "steps": rec["steps"],
            "launches": rec["launches"]}


def _check_tenants(recs, claim_uuid, device_type) -> list:
    """Every tenant trained to finite losses on the claim's device, and
    each one's timed window overlaps every other's for MIN_OVERLAP of
    its own length (MIN_OVERLAP_CPU on the CPU). Returns the overlap
    shares."""
    from tpu_dra_torch.workloads.meshbuild import normalize_uuid

    min_overlap = MIN_OVERLAP if device_type == "cuda" else MIN_OVERLAP_CPU

    for rec in recs:
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise RuntimeError(f"tenant {rec['pid']}: non-finite losses "
                               f"{rec['losses']}")
        seen = rec["uuid"] if device_type == "cuda" else rec["claim_uuids"][0]
        if normalize_uuid(seen) != normalize_uuid(claim_uuid):
            raise RuntimeError(f"tenant {rec['pid']} ran on {seen}, the "
                               f"claim holds {claim_uuid}")
    shares = []
    for a in recs:
        (s0, e0) = a["window"]
        for b in recs:
            if b is a:
                continue
            (s1, e1) = b["window"]
            share = max(0.0, min(e0, e1) - max(s0, s1)) / (e0 - s0)
            shares.append(share)
            if share < min_overlap:
                raise RuntimeError(
                    f"tenant {a['pid']}'s window {a['window']} overlaps "
                    f"tenant {b['pid']}'s {b['window']} for {share:.3f} of "
                    f"its length, under {min_overlap}: they did not share "
                    "the device")
    return shares


def bench_shared_claim(backend, *, config=None, child_argv=None,
                       device_type="cuda", gpu_index=None, solo=None,
                       mps_binary=None, scratch=None) -> dict:
    """One ResourceClaim of one GPU (`gpu_index`, the backend's first by
    default) prepared over the plugin's framed socket and consumed by
    N_TENANTS train-step processes at once, each a claim child
    (`child_argv`, default ``python -m tpu_dra_torch.bench claim-child``)
    under the claim's CDI env as a runtime applies it (runtime_env), one
    warm step, then SHARED_STEPS timed steps started together. `config`
    is the claim's opaque GpuConfig parameters (the default config
    without). `solo` is a solo tenant's record; without
    one, a solo tenant runs on the claim first. Tenants on the CPU
    (`device_type="cpu"`, the CPU tier) stand in for a card's.

    An MPS config runs the claim's control daemon through an MpsNodeSim
    (`mps_binary`, default the host's nvidia-cuda-mps-control) and has
    three outcomes: "a", the binary is not on PATH (nothing runs); "b",
    the prepare is refused where NVML cannot set the GPU's compute mode,
    and no Deployment, daemon process, claim spec, checkpoint entry or
    exclusive compute mode may remain; "c", the tenants run and the
    daemon must list all of them as clients. No process may hold a
    context on the GPU when an MPS claim is prepared.

    Raises on a failed check. Returns the readings: each tenant's median
    step time and tokens/s, their sum against the solo tenant's, the
    windows' overlap, the prepare and unprepare times."""
    from tpu_dra_torch.api.types import API_VERSION, GPU_DRIVER_NAME
    from tpu_dra_torch.gpuplugin.sharing import MPS_CONTROL
    from tpu_dra_torch.infra import featuregates
    from tpu_dra_torch.k8s import DEPLOYMENTS
    from tpu_dra_torch.native.gpuinfo import NVML_COMPUTEMODE_DEFAULT

    mps = ((config or {}).get("sharing") or {}).get("strategy") == "MPS"
    out = {"config": config or "default", "n_tenants": N_TENANTS,
           "steps": SHARED_STEPS, "backend": backend.kind}
    if mps and mps_binary is None:
        if shutil.which(MPS_CONTROL) is None:
            return {**out, "ran": False, "outcome": "a",
                    "reason": f"{MPS_CONTROL} is not on PATH"}
        mps_binary = [MPS_CONTROL]
    gpu = backend.get_gpu(gpu_index if gpu_index is not None
                          else backend.gpus()[0].index)
    argv = (list(child_argv or [sys.executable, "-m", "tpu_dra_torch.bench",
                                CLAIM_CHILD])
            + ["--device-type", device_type, "--steps", str(SHARED_STEPS),
               "--warm", "1", "--wait-go"])
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    configs = None
    if config is not None:
        configs = [{"source": "FromClaim", "requests": [], "opaque": {
            "driver": GPU_DRIVER_NAME,
            "parameters": {"apiVersion": API_VERSION, "kind": "GpuConfig",
                           **config}}}]
    gates_before = featuregates.Features.overrides_snapshot()
    if mps:
        featuregates.Features.set_from_string("MultiprocessSupport=true")
    bd = _BenchDriver(backend, scratch=scratch,
                      mps_binary=mps_binary if mps else None)
    try:
        obj = _make_claim(bd.cluster, [gpu.index], "shared-claim",
                          configs=configs)
        uid = obj["metadata"]["uid"]
        if mps:
            # A context outlives its process by a moment: wait for the
            # solo tenant's to go.
            deadline = time.monotonic() + 10.0
            while (procs := backend.running_processes(gpu.index)) \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            out["processes_at_prepare"] = procs
            if procs:
                raise RuntimeError(
                    f"processes {procs} hold a context on GPU {gpu.index}: "
                    "under EXCLUSIVE_PROCESS the MPS server could not open "
                    "its own")
        t0 = time.perf_counter()
        try:
            res = bd.prepare(obj)
        except RuntimeError as e:
            if not (mps and "nvmlDeviceSetComputeMode" in str(e)):
                raise
            left = {
                "deployments": [d["metadata"]["name"] for d in
                                bd.cluster.list(DEPLOYMENTS, MPS_NAMESPACE)],
                "daemon_processes": sorted(bd.mps_sim.processes),
                "claim_spec": bd.cdi.claim_spec_exists(uid),
                "checkpoint_entry": uid in bd.state.prepared_claim_uids(),
                "compute_mode": backend.compute_mode(gpu.index)}
            if any(left[k] for k in ("deployments", "daemon_processes",
                                     "claim_spec", "checkpoint_entry")) \
                    or left["compute_mode"] not in (NVML_COMPUTEMODE_DEFAULT,
                                                    None):
                raise RuntimeError(f"the refused MPS prepare left {left}")
            return {**out, "ran": False, "outcome": "b", "error": str(e),
                    "left": left}
        out["prepare_ms"] = (time.perf_counter() - t0) * 1e3
        edits = bd.cdi.container_edits(res.devices[0].cdi_device_ids)
        env, rewritten = runtime_env(edits)
        out["env_rewritten"] = rewritten
        pipe_dir = None
        if mps:
            from tpu_dra_torch.gpuplugin.sharing import ENV_MPS_PIPE

            pipe_dir = env[ENV_MPS_PIPE]
            out["daemon_env"] = bd.mps_sim.env(bd.state.checkpoint_snapshot()
                                               .claims[uid].devices[0]
                                               ["mps_deployment"])
        child_env = {**os.environ, **env}
        if solo is None:
            (solo,), _ = _run_tenants(argv, child_env, 1, cwd)
        peak = solo["max_memory_allocated"]
        if peak is not None and N_TENANTS * peak > gpu.memory_bytes:
            raise RuntimeError(f"{N_TENANTS} tenants of {peak} bytes each "
                               f"exceed the GPU's {gpu.memory_bytes}")
        recs, clients = _run_tenants(argv, child_env, N_TENANTS, cwd,
                                     pipe_dir=pipe_dir, control=mps_binary)
        out["overlap_shares"] = _check_tenants(recs, gpu.uuid, device_type)
        if mps and clients < N_TENANTS:
            raise RuntimeError(
                f"the MPS control daemon listed {clients} clients while "
                f"{N_TENANTS} tenants ran: a tenant opened its own context")
        out["mps_clients"] = clients if mps else None
        t0 = time.perf_counter()
        bd.unprepare([obj])
        out["unprepare_ms"] = (time.perf_counter() - t0) * 1e3
        left = {"claim_spec": bd.cdi.claim_spec_exists(uid),
                "checkpoint_entry": uid in bd.state.prepared_claim_uids()}
        if mps:
            left["deployments"] = bd.cluster.list(DEPLOYMENTS, MPS_NAMESPACE)
            # The node sim reaps the daemon on its next tick.
            left["daemon_alive"] = not bd.cluster.wait_for(
                lambda: not bd.mps_sim.processes, 30)
            left["compute_mode"] = backend.compute_mode(gpu.index)
        if left["claim_spec"] or left["checkpoint_entry"] \
                or left.get("deployments") or left.get("daemon_alive") \
                or left.get("compute_mode") not in (None,
                                                    NVML_COMPUTEMODE_DEFAULT):
            raise RuntimeError(f"unprepare left {left}")
    finally:
        bd.release_prepared()
        bd.close()
        featuregates.Features.restore_overrides(gates_before)
    tenants = [_tenant_reading(r) for r in recs]
    solo_r = _tenant_reading(solo)
    agg = sum(t["tokens_per_s"] for t in tenants)
    return {**out, "ran": True, "outcome": "c" if mps else None,
            "claim_uuid": gpu.uuid, "env": env, "solo": solo,
            "solo_median_step_s": solo_r["median_step_s"],
            "solo_tokens_per_s": solo_r["tokens_per_s"],
            "tenants": tenants,
            "step_x_solo": [t["median_step_s"] / solo_r["median_step_s"]
                            for t in tenants],
            "aggregate_tokens_per_s": agg,
            "aggregate_x_solo": agg / solo_r["tokens_per_s"]}


def mps_shared_config(solo_peak_bytes: int) -> dict:
    """The MPS tenants' GpuConfig: the reference demo's 50% active
    threads (demo/specs/tpu-test-multiprocess.yaml) and a pinned device
    memory limit of 1.5x the solo tenant's peak, in whole GiB."""
    gib = math.ceil(1.5 * solo_peak_bytes / (1 << 30))
    return {"sharing": {"strategy": "MPS", "mpsConfig": {
        "defaultActiveThreadPercentage": 50,
        "defaultPinnedDeviceMemoryLimit": f"{gib}Gi"}}}


def shared_claim_line(res: dict) -> dict:
    """bench_shared_claim's readings without the solo tenant's record."""
    return {k: v for k, v in res.items() if k != "solo"}


# ---------------------------------------------------------------------------
# Compute domains
# ---------------------------------------------------------------------------

def bench_cd_convergence() -> dict:
    """A two-node ComputeDomain from creation to both workload channel
    claims prepared (counterpart of bench.py:bench_cd_convergence): the
    controller, two CD kubelet plugins and two native domain daemons
    converging over the fake API server, simulated nodes with fake GPUs
    (testing.provision_two_node_cd). Host time. Raises if the domain does
    not converge or its teardown leaves anything behind."""
    from tpu_dra_torch.testing import provision_two_node_cd

    prov = provision_two_node_cd(namespace="bench")
    if not prov["ok"]:
        raise RuntimeError(f"the compute domain did not converge: "
                           f"{prov['error']}")
    left = prov["teardown"]
    if (not left["cd_deleted"] or left["labeled_nodes"]
            or left["daemonsets"] or left["templates"]
            or left["unprepare_errors"]):
        raise RuntimeError(f"the domain's teardown left {left}")
    return {"cd_convergence_s": prov["elapsed_s"],
            "envs": prov["envs"]}


def bench_cd_gpus(backend=None, device_type: str = "cuda",
                  allreduce_kw=None, train_kw=None) -> dict:
    """The node's GPUs as the ranks of a two-node ComputeDomain: two
    simulated nodes (each a FakeBackend of half the GPUs `backend` lists
    — NVML by default — with their UUIDs and NVLink places) provisioned
    through the compute-domain stack; each node's claim env (its GPUs, as
    node_env exports them) merged with its channel claim's. While the
    domain is up, each node runs its own launcher process (run_nodes)
    that holds only its env: launch_workloads(domain=) over its plan
    (plan_from_env) starts one rank per GPU (NCCL; gloo CPU ranks with
    device_type "cpu"), and the ranks of both nodes meet at the env's
    MASTER_ADDR:MASTER_PORT as the ranks their NODE_RANKs make them,
    checked by the psum of rank + 1 (n(n+1)/2). On that group: the
    all-reduce (64 MiB per rank, 10 iterations, unless `allreduce_kw`)
    and "train", the flagship DP x TP step over train_grid(n) (3 timed
    steps after one warm step, unless `train_kw`). Then the domain is
    torn down."""
    from tpu_dra_torch.testing import DomainSim, run_nodes
    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import meshbuild
    from tpu_dra_torch.workloads import _cuda

    if backend is None:
        _require_card(device_type)
        _cuda.build()   # once, before the ranks load the libraries
        nvml = gpuinfo.NativeBackend()
        try:
            gpus = nvml.gpus()
        finally:
            nvml.close()
    else:
        gpus = backend.gpus()
    if len(gpus) < 2 or len(gpus) % 2:
        raise RuntimeError(f"{len(gpus)} GPUs cannot be split over two "
                           "nodes")
    half = len(gpus) // 2
    backends = {"node-a": gpuinfo.FakeBackend(gpus[:half]),
                "node-b": gpuinfo.FakeBackend(gpus[half:])}
    if device_type == "cpu":
        by_uuid = None
    else:
        by_uuid = {meshbuild.normalize_uuid(
            torch.cuda.get_device_properties(i).uuid):
            torch.device("cuda", i)
            for i in range(torch.cuda.device_count())}
    runs = [("allreduce", allreduce_kw or {"nbytes_per_device": 64 << 20,
                                           "iters": 10}),
            ("train", train_kw or {"steps": 3, "warm_steps": 1})]
    with DomainSim(backends, namespace="bench") as sim:
        cd = sim.create_cd("bench-cd")
        prov = sim.prepare_channels(cd)
        if not prov["ok"]:
            raise RuntimeError(f"the compute domain did not converge: "
                               f"{prov['error']}")
        envs = sorted(({**node_env(backends[name]), **prov["envs"][name]}
                       for name in backends),
                      key=lambda e: int(e["NODE_RANK"]))
        nodes = []
        for env in envs:
            uuids = env["CUDA_VISIBLE_DEVICES"].split(",")
            devices = ([torch.device("cpu")] * len(uuids) if by_uuid is None
                       else [by_uuid[meshbuild.normalize_uuid(u)]
                             for u in uuids])
            nodes.append((runs, plan_from_env(env), devices, env))
        node_recs = run_nodes(meshbuild.launch_workloads, nodes)
        left = sim.teardown(cd, prov["claims"])
    train = node_recs[0]["train"]
    n = train["domain"]["world"]
    expect = n * (n + 1) / 2.0
    sums = [recs["train"]["domain"]["psum"] for recs in node_recs]
    step_s = statistics.median(train["step_times_s"])
    out = {"n_gpus": n, "nodes": {name: [g.uuid for g in b.gpus()]
                                  for name, b in backends.items()},
           "cd_convergence_s": prov["elapsed_s"], "teardown": left,
           "rendezvous": train["domain"]["rendezvous"],
           "node_ranks": [e["NODE_RANK"] for e in envs],
           "psum": {"values": sums, "expected": expect,
                    "ok": all(abs(v - expect) < 1e-3 for v in sums)},
           "records": node_recs[0], "train_grid": train["grid"],
           "train_median_step_s": step_s,
           "train_tokens_per_s": train["batch"] * (train["seq"] - 1)
           / step_s}
    if device_type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
        out["power_limit"] = gpuinfo.power_limit(0)
    return out


def main(argv) -> int:
    if argv[:1] == [CLAIM_CHILD]:
        return claim_child(argv[1:])
    if argv[:1] == ["mesh"]:
        print(json.dumps({"mesh_gpus": bench_mesh_gpus()}), flush=True)
        return 0
    if argv[:1] == ["cd"]:
        res = bench_cd_gpus()
        print(json.dumps({"cd_gpus": res}), flush=True)
        return 0 if res["psum"]["ok"] else 1
    if argv[:1] == ["ops"]:
        for name, rec in ops_benches():
            print(json.dumps({name: rec}), flush=True)
        return 0
    if argv[:1] == ["chaos"]:
        print(json.dumps({"chaos_recovery": bench_chaos_recovery()}),
              flush=True)
        return 0
    if argv[:1] == ["scale10k"]:
        print(json.dumps({"sched_scale10k": bench_sched_scale10k()}),
              flush=True)
        return 0
    nvml = gpuinfo.get_backend()
    try:
        # First, while this process holds no context on the card: under
        # EXCLUSIVE_PROCESS an MPS server cannot open its own beside one.
        shared = bench_shared_claim(nvml)
        print(json.dumps({"shared_claim": shared_claim_line(shared)}),
              flush=True)
        mps = bench_shared_claim(
            nvml, solo=shared["solo"],
            config=mps_shared_config(shared["solo"]["max_memory_allocated"]))
        print(json.dumps({"mps": shared_claim_line(mps)}), flush=True)
        print(json.dumps({"bench_mfu": bench_mfu(steps=5)}), flush=True)
        print(json.dumps({"long_ctx": bench_long_context(seq=8192)}),
              flush=True)
        print(json.dumps({"long_ctx_xl": bench_long_context(
            steps=3, seq=16384, prefix="long_ctx_xl")}), flush=True)
        for remat in ("dots", "full"):
            print(json.dumps({f"long_ctx_xl_{remat}": bench_long_context(
                steps=3, seq=16384, prefix="long_ctx_xl", remat=remat)}),
                flush=True)
        print(json.dumps({"moe": bench_moe()}), flush=True)
        print(json.dumps({"psum": bench_psum(node_env(nvml))}), flush=True)
        print(json.dumps({"claim_to_ready": bench_claim_to_ready(nvml)}),
              flush=True)
        print(json.dumps({"mesh_dataplane": bench_mesh_dataplane()}),
              flush=True)
    finally:
        nvml.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
