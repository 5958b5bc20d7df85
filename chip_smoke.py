#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line ({"phase": ...}):

1. probe   — the card (nvidia-smi name and power limit, torch name and
             compute capability, expected (9, 0)) and nvcc's version;
2. build   — compiles the three flash-attention kernels from
             tpu_dra_torch/workloads/csrc with nvcc for sm_90a;
3. kernels — each kernel against its plain PyTorch version on the card,
             on the same bf16 inputs, at small shapes and at the flagship
             attention shape; tolerance ||diff|| / ||ref|| <= TOL_REL for
             out/dq/dk/dv and |diff| <= 1e-4 for lse; then the same
             readings for a planted fault (one dropped 64-wide tile),
             which must exceed TOL_REL;
4. times   — each kernel at the main path's shape (B8 S1023 H16 D128,
             causal, rope): CUDA-event median, its roofline bound, its
             plain version's time and PyTorch's SDPA as the yardstick;
5. main    — the flagship TransformerLM train step through
             tpu_dra_torch.bench.bench_mfu, with the kernels' launch
             counts zeroed just before and read just after;
6. parity  — a reduced TransformerLM on the card, two seeds, the kernel
             path against the same path on the kernels' plain versions
             and against plain attention: logits and every gradient leaf.

Then it prints the kernels' summary as one JSON line, the nvidia-smi
name/power-limit line, and last {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero without that last line; it
refuses to run without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Kernel vs plain version on the card. On an H100 (80GB HBM3, 700 W) the
# sound kernels read at most 2.1e-3 (out) and 1.8e-4 (dq/dk/dv); one
# dropped 64-wide tile reads 0.10 or more.
TOL_REL = 5e-3   # out, dq, dk, dv: bf16 output rounding + summation order
TOL_LSE = 1e-4   # lse, absolute: fp32 sums in a different order
TOL_LOGITS = 1e-2   # model logits, relative norm (the reference's bound)
TOL_GRAD = 5e-2     # model gradient leaves, max-rel (the reference's bound)
SMALL = dict(b=2, h=2, d=64)
FLAGSHIP_ATTN = dict(b=8, h=16, d=128)
MAIN_S = 1023   # the train path attends over max_seq - 1 positions
H100_SXM = "NVIDIA H100 80GB HBM3"
SOURCES = {
    "flash_fwd": ("tpu_dra_torch/workloads/csrc/flash_fwd.cu",
                  "tpu_dra/workloads/flashattention.py:191"),
    "flash_bwd_dq": ("tpu_dra_torch/workloads/csrc/flash_bwd_dq.cu",
                     "tpu_dra/workloads/flashattention.py:269"),
    "flash_bwd_dkv": ("tpu_dra_torch/workloads/csrc/flash_bwd_dkv.cu",
                      "tpu_dra/workloads/flashattention.py:339"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_probe() -> dict:
    import torch

    from tpu_dra_torch.native import gpuinfo

    info = gpuinfo.probe()
    check(info["count"] >= 1, "no CUDA device counted")
    check(tuple(info["capability"]) == (9, 0),
          f"kernels are built for sm_90a; card is sm_{info['capability']}")
    nvcc = info["nvcc"]
    check(nvcc is not None, "nvcc not found")
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    info["nvcc_version"] = version.splitlines()[-1] if version else ""
    info["torch"] = torch.__version__
    info["torch_cuda"] = torch.version.cuda
    emit("probe", **info)
    return info


def phase_build() -> None:
    from tpu_dra_torch.workloads import _flash_kernels as fk

    t0 = time.perf_counter()
    libs = fk.build()
    seconds = time.perf_counter() - t0
    emit("build", seconds=seconds, libs=[str(p) for p in libs.values()])


def _inputs(b, s, h, d, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    # q, k, v as views of one fused projection, as the model passes them.
    qkv = randn(b, s, 3 * h * d)
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dout = randn(b, s, h, d)
    dlse = randn(b, h, s, dtype=torch.float32) * 0.1
    return q, k, v, dout, dlse


def _tables(s, d, rope):
    import torch

    from tpu_dra_torch.workloads.flashattention import _rope_operands

    return (_rope_operands(s, d, torch.bfloat16, torch.device("cuda"))
            if rope else None)


def _rel_norm(got, ref) -> float:
    """||got - ref|| / ||ref||: every row weighs by its own size, so an
    error confined to the far rows of a causal output (whose values are
    small beside row 0's) still shows."""
    ref = ref.float()
    return float((got.float() - ref).norm() / max(float(ref.norm()), 1e-12))


def _max_rel(got, ref) -> float:
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


def _abs(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_case(s, causal, rope, b, h, d, seed) -> dict:
    """Every kernel against its plain version on one set of inputs."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v, dout, dlse = _inputs(b, s, h, d, seed)
    tables = _tables(s, d, rope)
    o, lse = fk.fwd(q, k, v, tables, causal=causal)
    o_ref, lse_ref = fk.fwd_plain(q, k, v, tables, causal=causal)
    # The backward pair takes the kernel's (o, lse) on both sides.
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta, dlse, tables)
    dq = fk.bwd_dq(*args, causal=causal)
    dk, dv = fk.bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    dq_ref = fk.bwd_dq_plain(*args, causal=causal)
    dk_ref, dv_ref = fk.bwd_dkv_plain(*args, causal=causal)
    finite = all(bool(torch.isfinite(x.float()).all())
                 for x in (o, lse, dq, dk, dv))
    res = {
        "s": s, "causal": causal, "rope": rope, "b": b, "h": h, "d": d,
        "finite": finite,
        "out_rel": _rel_norm(o, o_ref), "lse_abs": _abs(lse, lse_ref),
        "dq_rel": _rel_norm(dq, dq_ref), "dk_rel": _rel_norm(dk, dk_ref),
        "dv_rel": _rel_norm(dv, dv_ref),
        "out_abs": _abs(o, o_ref), "dq_abs": _abs(dq, dq_ref),
        "dk_abs": _abs(dk, dk_ref), "dv_abs": _abs(dv, dv_ref),
    }
    emit("kernels", **res)
    check(finite, f"non-finite kernel output at {res}")
    for key in ("out_rel", "dq_rel", "dk_rel", "dv_rel"):
        check(res[key] <= TOL_REL, f"{key} {res[key]} > {TOL_REL} at {res}")
    check(res["lse_abs"] <= TOL_LSE,
          f"lse_abs {res['lse_abs']} > {TOL_LSE} at {res}")
    return res


def phase_kernels() -> dict:
    cases = [(384, c, r) for c in (True, False) for r in (True, False)]
    cases += [(1023, True, True), (1023, True, False), (40, False, True)]
    for i, (s, causal, rope) in enumerate(cases):
        check_case(s, causal, rope, seed=i, **SMALL)
    check_case(1024, True, True, seed=100, **FLAGSHIP_ATTN)
    res = check_case(MAIN_S, True, True, seed=101, **FLAGSHIP_ATTN)
    planted_faults(MAIN_S, seed=101, **FLAGSHIP_ATTN)
    return res


def planted_faults(s, b, h, d, seed, tile_start=512) -> dict:
    """What the kernel checks read for a kernel that drops one 64-wide
    tile, at the main path's inputs: the plain versions against
    themselves with keys [tile_start, +64) cut from the forward's softmax
    and from dq's dS.K, and queries [tile_start, +64) cut from dk/dv's
    stream. Each reading must clear TOL_REL, or the check could not see
    such a fault. The old max|diff| / max|ref| reading is printed beside
    it."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v, dout, dlse = _inputs(b, s, h, d, seed)
    tables = _tables(s, d, True)
    t = slice(tile_start, tile_start + fk.BLOCK)
    scale = 1.0 / math.sqrt(d)
    o, lse = fk.fwd_plain(q, k, v, tables, causal=True)
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta, dlse, tables)
    dq = fk.bwd_dq_plain(*args, causal=True)
    dk, dv = fk.bwd_dkv_plain(*args, causal=True)

    def bf16_dot(spec, a, x):
        return torch.einsum(spec, a.to(torch.bfloat16).float(), x.float())

    def unrope(x):
        return fk.rope_rotate(x, *tables, inverse=True).to(q.dtype)

    scores, qr, kr = fk._scores(q, k, tables, True)
    scores[..., t] = fk.NEG_INF
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    o_fault = (bf16_dot("bhqk,bkhd->bqhd", p, v)
               / p.sum(-1).permute(0, 2, 1)[..., None]).to(q.dtype)
    del scores
    p, ds, _, _ = fk._probs_and_ds(*args, causal=True)
    ds_k = ds.clone()
    ds_k[..., t] = 0
    dq_fault = unrope(bf16_dot("bhqk,bkhd->bqhd", ds_k, kr) * scale)
    del ds_k
    p[..., t, :] = 0
    ds[..., t, :] = 0
    dv_fault = bf16_dot("bhqk,bqhd->bkhd", p, dout).to(q.dtype)
    dk_fault = unrope(bf16_dot("bhqk,bqhd->bkhd", ds, qr) * scale)
    res = {}
    for name, fault, ref in (("out", o_fault, o), ("dq", dq_fault, dq),
                             ("dk", dk_fault, dk), ("dv", dv_fault, dv)):
        res[f"{name}_rel"] = _rel_norm(fault, ref)
        res[f"{name}_max_rel"] = _max_rel(fault, ref)
    emit("planted_faults", s=s, b=b, h=h, d=d, tile_start=tile_start,
         tol_rel=TOL_REL, **res)
    for name in ("out", "dq", "dk", "dv"):
        check(res[f"{name}_rel"] > TOL_REL,
              f"a dropped tile reads {res[name + '_rel']} on {name}, within "
              f"TOL_REL {TOL_REL}: the check cannot see it")
    return res


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over `reps` CUDA-event windows of `inner` back-to-back calls,
    per call, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bounds(b, s, h, d, peak_flops, peak_bytes) -> dict:
    """Least time for each kernel's work at this shape: the larger of its
    tensor-core FLOPs (causal pairs only) over the bf16 peak and its
    compulsory bytes (each input read once, each output written once)
    over the memory rate."""
    pairs = b * h * s * (s + 1) // 2
    tile = b * s * h * d * 2          # one bf16 [B, S, H, D] operand
    row = b * h * s * 4               # one fp32 [B, H, S] row vector
    tables = 2 * s * d * 2            # bf16 cos and sinm
    work = {
        # q, k, v in; o, lse out. QK^T and PV.
        "flash_fwd": (4 * d * pairs, 4 * tile + row + tables),
        # q, k, v, dO, lse, delta, dlse in; dq out. QK^T, dO V^T, dS K.
        "flash_bwd_dq": (6 * d * pairs, 5 * tile + 3 * row + tables),
        # as dq in; dk, dv out. QK^T, dO V^T, P^T dO, dS^T Q.
        "flash_bwd_dkv": (8 * d * pairs, 6 * tile + 3 * row + tables),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        out[name] = {
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def phase_times(peak_flops: float, peak_bytes: float) -> dict:
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.workloads import _flash_kernels as fk

    b, h, d, s = FLAGSHIP_ATTN["b"], FLAGSHIP_ATTN["h"], FLAGSHIP_ATTN["d"], MAIN_S
    q, k, v, dout, dlse = _inputs(b, s, h, d, seed=7)
    dlse.zero_()   # the model's path: out-only consumer
    tables = _tables(s, d, True)
    o, lse = fk.fwd(q, k, v, tables, causal=True)
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, dlse, tables)
    ms = {
        "flash_fwd": time_ms(lambda: fk.fwd(q, k, v, tables, causal=True)),
        "flash_bwd_dq": time_ms(lambda: fk.bwd_dq(*args, causal=True)),
        "flash_bwd_dkv": time_ms(lambda: fk.bwd_dkv(*args, causal=True)),
    }
    plain_ms = {
        "flash_fwd": time_ms(lambda: fk.fwd_plain(q, k, v, tables,
                                                  causal=True), 3, 1),
        "flash_bwd_dq": time_ms(lambda: fk.bwd_dq_plain(*args, causal=True),
                                3, 1),
        "flash_bwd_dkv": time_ms(lambda: fk.bwd_dkv_plain(*args, causal=True),
                                 3, 1),
    }
    # Yardstick only (the port never calls it): SDPA on the roped inputs,
    # [B, H, S, D] contiguous, forward and backward (dq, dk, dv together).
    qr, kr = (fk.rope_rotate(x, *tables).transpose(1, 2).contiguous()
              for x in (q, k))
    vr = v.transpose(1, 2).contiguous()
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qr, kr, vr))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    do_t = dout.transpose(1, 2).contiguous()
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do_t, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
               "flash_bwd_dkv": sdpa_bwd}
    bnd = bounds(b, s, h, d, peak_flops, peak_bytes)
    res = {name: {"ms": ms[name], "plain_ms": plain_ms[name],
                  "library_ms": library[name], **bnd[name]} for name in ms}
    emit("times", shape=dict(b=b, s=s, h=h, d=d, causal=True, rope=True),
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd,
         peak_flops=peak_flops, peak_bytes_per_s=peak_bytes, kernels=res)
    return res


def phase_main_path() -> tuple[dict, dict]:
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _flash_kernels as fk

    fk.reset_launches()
    res = bench.bench_mfu(steps=5)
    counts = fk.launches()
    emit("main", launches=counts, **res)
    check(math.isfinite(res["loss"]), f"non-finite loss {res['loss']}")
    want = res["n_layers"] * res["step_calls"]
    for name, n in counts.items():
        check(n == want, f"{name} launched {n} times in the main path, "
                         f"want n_layers x steps = {want}")
    return res, counts


@contextlib.contextmanager
def plain_kernels():
    """The flash path with each kernel wrapper swapped for its plain
    version (the same rounding points), restored on exit."""
    from tpu_dra_torch.workloads import _flash_kernels as fk

    saved = fk.fwd, fk.bwd_dq, fk.bwd_dkv
    fk.fwd, fk.bwd_dq, fk.bwd_dkv = (fk.fwd_plain, fk.bwd_dq_plain,
                                     fk.bwd_dkv_plain)
    try:
        yield
    finally:
        fk.fwd, fk.bwd_dq, fk.bwd_dkv = saved


def _model_run(base, params, tokens, impl):
    """(logits, loss, grads, leaf names) of a fresh model on a copy of
    `params`."""
    import torch

    from tpu_dra_torch.workloads.model import (
        ModelConfig, TransformerLM, loss_fn,
    )

    model = TransformerLM(ModelConfig(**base, attn_impl=impl), {
        "embed": params["embed"].clone(),
        "unembed": params["unembed"].clone(),
        "blocks": [{n: t.clone() for n, t in bp.items()}
                   for bp in params["blocks"]]})
    logits = model(tokens[:, :-1]).detach()
    loss = loss_fn(model, tokens)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (logits, float(loss.detach()), grads,
            [n for n, _ in model.named_parameters()])


def phase_model_parity(seeds=(1, 2)) -> dict:
    """The kernel path against two plain paths, per seed: "plain" is the
    same flash path with every kernel swapped for its plain version (the
    same rounding points, so only summation order differs); "reference"
    is plain attention with bf16 scores, as the reference model's own
    parity test compares. Both within the reference's bf16 bounds."""
    import torch

    from tpu_dra_torch.workloads.model import ModelConfig, init_params

    base = dict(vocab=1024, d_model=512, n_heads=4, n_layers=2, d_ff=1024,
                max_seq=256)
    out = {}
    for seed in seeds:
        params = init_params(ModelConfig(**base),
                             torch.Generator().manual_seed(seed), "cuda")
        tokens = torch.randint(
            0, base["vocab"], (2, base["max_seq"]),
            generator=torch.Generator().manual_seed(seed + 1000)).cuda()
        lk, loss_k, gk, names = _model_run(base, params, tokens, "auto")
        check(math.isfinite(loss_k) and bool(torch.isfinite(lk).all()),
              "non-finite kernel-path logits or loss")
        with plain_kernels():
            plain = _model_run(base, params, tokens, "flash")
        ref = _model_run(base, params, tokens, "reference")
        for against, (lr, loss_r, gr, _) in (("plain", plain),
                                             ("reference", ref)):
            logits_rel = float((lk - lr).norm() / lr.norm())
            grad_rel = {n: _max_rel(a, b) for n, a, b in zip(names, gk, gr)}
            worst = max(grad_rel, key=grad_rel.get)
            res = dict(seed=seed, against=against, logits_rel=logits_rel,
                       loss_kernel=loss_k, loss_against=loss_r,
                       worst_grad=worst, worst_grad_rel=grad_rel[worst])
            emit("parity", config=base, **res, grad_rel=grad_rel)
            check(logits_rel <= TOL_LOGITS, f"logits rel {res}")
            check(grad_rel[worst] <= TOL_GRAD, f"grad rel {res}")
            out[(seed, against)] = res
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tpu_dra_torch.native import gpuinfo

    # Plain versions and the parity reference compute in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    info = phase_probe()
    phase_build()
    flagship = phase_kernels()
    # Bounds are against the H100 SXM's published peaks (700 W).
    times = phase_times(gpuinfo.PEAK_BF16_TFLOPS[H100_SXM] * 1e12,
                        gpuinfo.PEAK_HBM_BYTES_PER_S[H100_SXM])
    _, counts = phase_main_path()
    phase_model_parity()
    err = {"flash_fwd": flagship["out_abs"], "flash_bwd_dq": flagship["dq_abs"],
           "flash_bwd_dkv": max(flagship["dk_abs"], flagship["dv_abs"])}
    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"] or f"{info['name']}, power limit not reported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
