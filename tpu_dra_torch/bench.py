"""Train-step throughput of the flagship model on one NVIDIA GPU, and
claim-to-ready of the kubelet plugin (counterpart of bench.py's
bench_mfu, bench_long_context, bench_claim_to_ready and their helpers).

bench_mfu, bench_long_context and profile_train_step are device
measurements: they run on a CUDA device or raise. bench_claim_to_ready
times the kubelet plugin over its sockets on any discovery backend.

    python -m tpu_dra_torch.bench
    # one JSON line each: mfu, long_ctx (S=8192), long_ctx_xl (S=16384),
    # profile (flagship), profile_xl (S=16384) and claim_to_ready (the
    # node's GPUs through NVML)
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import tempfile
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
LONG_CONTEXT_BATCH = 1
TOP_KERNELS = 15


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(cfg: ModelConfig, batch: int, device: torch.device):
    """(model, tokens, step): weights from seed 0, tokens from numpy
    RandomState(0), as the reference's bench draws them."""
    model = TransformerLM(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), device))
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, (batch, cfg.max_seq)),
        dtype=torch.long, device=device)
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
                       prefix: str = "long_ctx", device="cuda") -> dict:
    """Long-context train step of the flagship model on one card, batch 1
    (counterpart of bench.py:bench_long_context): attention goes through
    the same three kernels at every S, where the reference moves to its
    streaming kernels past its VMEM budget (S=16384 in bf16). Returns the
    reference's keys ({prefix}_seq, _step_s, _tokens_per_s with seq - 1
    trained tokens per step, and _mfu against the card's dense bf16 peak,
    None for a card the peak table does not know) plus the final loss,
    the step calls made, the depth, the peak of allocated device memory
    and the card's name and power limit."""
    device = _require_card(device)
    cfg = long_context_config(seq)
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
        "loss": loss_v,
        "step_calls": calls,
        "n_layers": cfg.n_layers,
        "peak_memory_bytes": peak_bytes,
        "device_name": name,
        "power_limit": gpuinfo.power_limit(device.index or 0),
    }


def _category(kernel: str) -> str:
    name = kernel.lower()
    if "flash_" in name:
        return "flash attention (port kernels)"
    if any(tag in name for tag in ("nvjet", "gemm", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "copy_kernel" in name:
        return "dtype casts and copies"
    return "other elementwise and reductions"


def profile_train_step(steps: int = 3, device="cuda", cfg=FLAGSHIP,
                       batch: int = FLAGSHIP_BATCH) -> dict:
    """Device time of a train step (the flagship's by default) by kernel,
    from torch.profiler's CUDA activity over `steps` steps after a warm
    one: the per-step device-busy time, the window it sits in (first
    kernel start to last kernel end) and so the device's idle share, the
    busy time by category and the TOP_KERNELS kernels with most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = _require_card(device)
    _, tokens, step = _setup(cfg, batch, device)
    step(tokens)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(tokens)
        _sync(device)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_events": 0}
    busy, cursor = 0.0, spans[0][0]
    by_name: dict[str, list] = {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += end - start
        entry[1] += 1
    window = spans[-1][1] - spans[0][0]
    by_cat: dict[str, float] = {}
    for name, (us, _) in by_name.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        "device_events": len(spans),
        "seq": cfg.max_seq,
        "batch": batch,
        "steps": steps,
        "busy_ms_per_step": busy / steps / 1e3,
        "window_ms_per_step": window / steps / 1e3,
        "idle_share": 1.0 - busy / window,
        "ms_per_step_by_category": {k: v / steps / 1e3
                                    for k, v in by_cat.items()},
        "top_kernels": [{"name": name[:120], "ms_per_step": us / steps / 1e3,
                         "calls_per_step": n / steps}
                        for name, (us, n) in ranked],
        "device_name": torch.cuda.get_device_name(device),
        "power_limit": gpuinfo.power_limit(device.index or 0),
    }


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
    `scratch` (the process's temporary directory by default)."""

    def __init__(self, backend, scratch=None):
        from tpu_dra_torch.api.types import GPU_DRIVER_NAME
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState
        from tpu_dra_torch.gpuplugin.driver import GpuDriver
        from tpu_dra_torch.gpuplugin.sharing import TimeSlicingManager
        from tpu_dra_torch.k8s import FakeCluster
        from tpu_dra_torch.kubeletplugin.server import (
            framed_stubs, kubelet_stubs,
        )

        self.backend = backend
        self.cluster = FakeCluster()
        self.tmp = tempfile.mkdtemp(prefix="ctr-", dir=scratch)
        self.cdi_dir = os.path.join(self.tmp, "cdi")
        self.cdi = CDIHandler(self.cdi_dir,
                              driver_root=os.path.join(self.tmp, "drv"))
        self.state = DeviceState(
            backend=backend, cdi=self.cdi,
            checkpoints=CheckpointManager(os.path.join(self.tmp, "p")),
            driver_name=GPU_DRIVER_NAME, node_name=BENCH_NODE,
            ts_manager=TimeSlicingManager(backend))
        self.grpc_unavailable = grpc_unavailable()
        self.driver = GpuDriver(state=self.state, client=self.cluster,
                                driver_name=GPU_DRIVER_NAME,
                                node_name=BENCH_NODE,
                                plugin_dir=os.path.join(self.tmp, "p"),
                                registry_dir=os.path.join(self.tmp, "r"),
                                kubelet_grpc=self.grpc_unavailable is None)
        self.driver.start()
        if not self.driver.first_published.is_set():
            raise RuntimeError("the plugin's first ResourceSlice publish "
                               "did not land")
        self.channel = None
        self._prepare_grpc = self._unprepare_grpc = None
        if self.grpc_unavailable is None:
            self.channel, self._prepare_grpc, self._unprepare_grpc = \
                kubelet_stubs(self.driver.server.dra_socket)
        self.framed_client, self._prepare_framed, self._unprepare_framed = \
            framed_stubs(self.driver.server.fast_socket, timeout_s=60.0)
        self.gpus = [g.index for g in backend.gpus()]

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

    def close(self):
        if self.channel is not None:
            self.channel.close()
        self.framed_client.close()
        self.driver.shutdown()
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
    subslice key (None: MIG is not ported). The reference's key names;
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
        "claim_to_ready_p50_subslice_ms": None,
        "claim_to_ready_subslice_unavailable": "MIG devices are not "
                                               "ported yet",
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


if __name__ == "__main__":
    print(json.dumps({"bench_mfu": bench_mfu(steps=5)}), flush=True)
    print(json.dumps({"long_ctx": bench_long_context(seq=8192)}), flush=True)
    print(json.dumps({"long_ctx_xl": bench_long_context(
        steps=3, seq=16384, prefix="long_ctx_xl")}), flush=True)
    print(json.dumps({"profile": profile_train_step()}), flush=True)
    print(json.dumps({"profile_xl": profile_train_step(
        steps=2, cfg=long_context_config(16384),
        batch=LONG_CONTEXT_BATCH)}), flush=True)
    nvml = gpuinfo.get_backend()
    try:
        print(json.dumps({"claim_to_ready": bench_claim_to_ready(nvml)}),
              flush=True)
    finally:
        nvml.close()
