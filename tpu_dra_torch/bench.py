"""Train-step throughput of the flagship model on one NVIDIA GPU
(counterpart of bench.py's bench_mfu, bench_long_context and their
helpers).

bench_mfu, bench_long_context and profile_train_step are device
measurements: they run on a CUDA device or raise.

    python -m tpu_dra_torch.bench
    # one JSON line each: mfu, long_ctx (S=8192), long_ctx_xl (S=16384),
    # profile (flagship) and profile_xl (S=16384)
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

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


if __name__ == "__main__":
    print(json.dumps({"bench_mfu": bench_mfu(steps=5)}), flush=True)
    print(json.dumps({"long_ctx": bench_long_context(seq=8192)}), flush=True)
    print(json.dumps({"long_ctx_xl": bench_long_context(
        steps=3, seq=16384, prefix="long_ctx_xl")}), flush=True)
    print(json.dumps({"profile": profile_train_step()}), flush=True)
    print(json.dumps({"profile_xl": profile_train_step(
        steps=2, cfg=long_context_config(16384),
        batch=LONG_CONTEXT_BATCH)}), flush=True)
