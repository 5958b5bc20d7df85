#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line ({"phase": ...}):

1. probe        — the card (nvidia-smi name and power limit, torch name
                  and compute capability, expected (9, 0)) and nvcc's
                  version;
2. build        — compiles the four flash-attention kernels from
                  tpu_dra_torch/workloads/csrc with nvcc for sm_90a;
3. kernels      — each kernel against its plain PyTorch version on the
                  card, on the same bf16 inputs (q, k, v views of one
                  fused projection, as the model passes them), at small
                  shapes (S=40 and 384, causal and not, rope and not, at
                  D=64 and 128: every branch of the Hopper forward
                  flash_fwd_sm90; D=32 for the bf16 mma.sync forward)
                  and at the flagship attention shape; tolerance
                  ||diff|| / ||ref|| <= TOL_REL for out/dq/dk/dv and
                  |diff| <= TOL_LSE for lse; then the same readings for a
                  planted fault (one dropped 64-wide tile), which must
                  exceed TOL_REL;
4. kernels_fp32 — the same on fp32 inputs at the reference's streaming
                  tier's shapes (its TestStreamingKernels' B2 S384 H2
                  D16, causal x rope, and B1 S8192 H2 D128, where its
                  fp32 path streams) and at the fp32 model's (B1 S8191
                  H4 D128), within TOL_REL_FP32 / TOL_LSE_FP32;
5. kernels_long — bf16 at the long-context paths' shapes, B1 H16 D128
                  at S=8191 and 16383, and at S=16384, each kernel run
                  once at the full shape and its plain version two heads
                  at a time; a planted fault at 8192 of S=16383;
6. times        — each kernel at the main path's shape (B8 S1023 H16
                  D128, causal, rope): CUDA-event median, its roofline
                  bound, its plain version's time and PyTorch's SDPA as
                  the yardstick; times_xl the same at B1 S16384 H16 D128
                  (plain versions at H2), times_fp32 at B1 S8192 H2 D128
                  fp32 against the 3xTF32 product path's peak;
7. main         — the flagship TransformerLM train step through
                  tpu_dra_torch.bench.bench_mfu, with the kernels' launch
                  counts zeroed just before and read just after: every
                  forward through flash_fwd_sm90, n_layers x step calls
                  of each kernel;
8. long_ctx     — tpu_dra_torch.bench.bench_long_context at S=8192 and
                  at S=16384 (long_ctx_xl), each with the launch counts
                  zeroed just before and read just after, checked as in
                  main;
9. parity       — a reduced TransformerLM on the card, two seeds, the
                  kernel path against the same path on the kernels' plain
                  versions and against plain attention: logits and every
                  gradient leaf; parity_fp32 the kernel path of an fp32
                  model at S=8192 against its plain versions.

Then it prints the kernels' summary as one JSON line (one entry per TPU
kernel: rows 1-3 at the main path, rows 4-6, the streaming tier, at
S=16384), the nvidia-smi name/power-limit line, and last {"ok": true,
"device": {...}}. Any failed check raises, so the script exits non-zero
without that last line; it refuses to run without a CUDA device.
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
# sound kernels read at most 2.1e-3 (out) and 4.4e-4 (dq/dk/dv, at
# S=16384); one dropped 64-wide tile reads 0.10 or more at S=1023 and
# 0.02 or more at S=16384.
TOL_REL = 5e-3   # out, dq, dk, dv: bf16 output rounding + summation order
TOL_LSE = 1e-4   # lse, absolute: fp32 sums in a different order
TOL_LOGITS = 1e-2   # model logits, relative norm (the reference's bound)
TOL_GRAD = 5e-2     # model gradient leaves, max-rel (the reference's bound)
# fp32 kernels against their fp32 plain versions: the reference's fp32
# kernel bound (tests/test_torch_flashattention.py:11-13); the 3xTF32
# products drop only a_lo.b_lo, ~2^-22 relative.
TOL_REL_FP32 = 2e-5   # out, dq, dk, dv
TOL_LSE_FP32 = 2e-5   # lse, absolute
TOL_LOGITS_FP32 = 1e-4   # fp32 model logits, relative norm
TOL_GRAD_FP32 = 1e-3     # fp32 model gradient leaves, max-rel
SMALL = dict(b=2, h=2, d=64)
FLAGSHIP_ATTN = dict(b=8, h=16, d=128)
MAIN_S = 1023   # the train path attends over max_seq - 1 positions
# The long-context paths: bench_long_context at S=8192 and 16384 runs
# the kernels at B1 H16 D128 over 8191 and 16383 positions; the times
# take S=16384. The kernels are checked at those full shapes; their dense
# plain versions run PLAIN_HEADS heads at a time, since at 16 heads the
# plain backward holds four [1, 16, S, S] fp32 tensors of 17 GB each.
LONG_S = 8192
XL_S = 16384
XL_ATTN = dict(b=1, h=16, d=128)
PLAIN_HEADS = 2
LONG_CHECK = dict(b=1, h=2, d=128)
FP32_LONG_S = 8192   # where the reference's fp32 path streams
FP32_MODEL_ATTN = dict(b=1, h=4, d=128)   # parity_fp32's attention
H100_SXM = "NVIDIA H100 80GB HBM3"
SOURCES = {
    "flash_fwd_sm90": "tpu_dra_torch/workloads/csrc/flash_fwd_sm90.cu",
    "flash_fwd": "tpu_dra_torch/workloads/csrc/flash_fwd.cu",
    "flash_bwd_dq": "tpu_dra_torch/workloads/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "tpu_dra_torch/workloads/csrc/flash_bwd_dkv.cu",
}
# Every TPU kernel in the repo: (entry name, wrapper, port kernel on the
# main path, replaces). Rows 4-6, the streaming tier, are the same
# kernels held at the tier's shapes (tpu_dra_torch/workloads/
# flashattention.py says why). The forward wrapper routes bf16 at D 64
# and 128 (every model path) to flash_fwd_sm90, fp32 to flash_fwd.
TPU_KERNELS = [
    ("flash_fwd", "flash_fwd", "flash_fwd_sm90",
     "tpu_dra/workloads/flashattention.py:191"),
    ("flash_bwd_dq", "flash_bwd_dq", "flash_bwd_dq",
     "tpu_dra/workloads/flashattention.py:269"),
    ("flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd_dkv",
     "tpu_dra/workloads/flashattention.py:339"),
    ("flash_fwd_xl", "flash_fwd", "flash_fwd_sm90",
     "tpu_dra/workloads/flashattention.py:491"),
    ("flash_bwd_dq_xl", "flash_bwd_dq", "flash_bwd_dq",
     "tpu_dra/workloads/flashattention.py:550"),
    ("flash_bwd_dkv_xl", "flash_bwd_dkv", "flash_bwd_dkv",
     "tpu_dra/workloads/flashattention.py:601"),
]
# What a bf16 model path at D=128 launches per forward/backward: the
# Hopper forward, never the mma.sync one.
MODEL_PATH_KERNELS = ("flash_fwd_sm90", "flash_bwd_dq", "flash_bwd_dkv")


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


def _inputs(b, s, h, d, seed, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, to=dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(to)

    # q, k, v as views of one fused projection, as the model passes them.
    qkv = randn(b, s, 3 * h * d)
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dout = randn(b, s, h, d)
    dlse = randn(b, h, s, to=torch.float32) * 0.1
    return q, k, v, dout, dlse


def _tables(s, d, rope, dtype=None):
    import torch

    from tpu_dra_torch.workloads.flashattention import _rope_operands

    return (_rope_operands(s, d, dtype or torch.bfloat16,
                           torch.device("cuda")) if rope else None)


def _free() -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _max_rel(got, ref) -> float:
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


class Diff:
    """got against ref for one output, summed over head chunks, so that
    the readings are those of the whole tensors: ||got - ref|| / ||ref||
    (`rel`: every row weighs by its own size, so an error confined to the
    far rows of a causal output, whose values are small beside row 0's,
    still shows), max |got - ref| (`abs`) and max |got - ref| / max |ref|
    (`max_rel`)."""

    def __init__(self):
        self.diff_sq = self.ref_sq = self.diff_max = self.ref_max = 0.0

    def add(self, got, ref) -> None:
        ref = ref.float()
        diff = got.float() - ref
        self.diff_sq += float(diff.square().sum())
        self.ref_sq += float(ref.square().sum())
        self.diff_max = max(self.diff_max, float(diff.abs().max()))
        self.ref_max = max(self.ref_max, float(ref.abs().max()))

    @property
    def rel(self) -> float:
        return math.sqrt(self.diff_sq) / max(math.sqrt(self.ref_sq), 1e-12)

    @property
    def abs(self) -> float:
        return self.diff_max

    @property
    def max_rel(self) -> float:
        return self.diff_max / max(self.ref_max, 1e-6)


def _heads(args, hs):
    """The operands (q, k, v, dout, lse, delta, dlse, tables) of heads
    `hs`: [B, S, H, D] tensors sliced on dim 2, [B, H, S] ones on dim 1."""
    q, k, v, dout, lse, delta, dlse, tables = args
    return (*(x[:, :, hs] for x in (q, k, v, dout)),
            *(x[:, hs] for x in (lse, delta, dlse)), tables)


def check_case(s, causal, rope, b, h, d, seed, dtype=None, chunk=None,
               fault_at=None) -> dict:
    """Every kernel once on one set of [b, s, h, d] inputs (bf16 unless
    `dtype` says otherwise; q, k, v views of one fused projection, as the
    model passes them), against its plain version on the same tensors,
    `chunk` heads at a time (all at once by default: the dense plain
    backward at long S holds four [B, chunk, S, S] fp32 tensors), at the
    tolerances of that type. With `fault_at`, also the planted-fault
    readings at these inputs (planted_faults)."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol_rel = TOL_REL_FP32 if fp32 else TOL_REL
    tol_lse = TOL_LSE_FP32 if fp32 else TOL_LSE
    chunk = chunk or h
    q, k, v, dout, dlse = _inputs(b, s, h, d, seed, dtype)
    tables = _tables(s, d, rope, dtype)
    o, lse = fk.fwd(q, k, v, tables, causal=causal)
    # The backward pair takes the kernel's (o, lse) on both sides.
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta, dlse, tables)
    dq = fk.bwd_dq(*args, causal=causal)
    dk, dv = fk.bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x.float()).all())
                 for x in (o, lse, dq, dk, dv))
    names = ("out", "lse", "dq", "dk", "dv")
    diffs = {name: Diff() for name in names}
    faults = {name: Diff() for name in names if name != "lse"}
    for h0 in range(0, h, chunk):
        hs = slice(h0, h0 + chunk)
        sub = _heads(args, hs)
        o_ref, lse_ref = fk.fwd_plain(*sub[:3], tables, causal=causal)
        refs = {"out": o_ref, "lse": lse_ref,
                "dq": fk.bwd_dq_plain(*sub, causal=causal)}
        refs["dk"], refs["dv"] = fk.bwd_dkv_plain(*sub, causal=causal)
        for name, got in zip(names, (o[:, :, hs], lse[:, hs], dq[:, :, hs],
                                     dk[:, :, hs], dv[:, :, hs])):
            diffs[name].add(got, refs[name])
        if fault_at is not None:
            for name, fault in planted_faults(sub, fault_at).items():
                faults[name].add(fault, refs[name])
        del sub, refs, o_ref, lse_ref
    res = {
        "s": s, "causal": causal, "rope": rope, "b": b, "h": h, "d": d,
        "dtype": str(dtype).removeprefix("torch."),
        "fwd_kernel": fk.FWD_KERNELS[fk.fwd_route(dtype, d)], "finite": finite,
        "plain_heads_per_pass": chunk, "lse_abs": diffs["lse"].abs,
        **{f"{n}_rel": diffs[n].rel for n in names if n != "lse"},
        **{f"{n}_abs": diffs[n].abs for n in names if n != "lse"},
    }
    emit("kernels", **res)
    check(finite, f"non-finite kernel output at {res}")
    for key in ("out_rel", "dq_rel", "dk_rel", "dv_rel"):
        check(res[key] <= tol_rel, f"{key} {res[key]} > {tol_rel} at {res}")
    check(res["lse_abs"] <= tol_lse,
          f"lse_abs {res['lse_abs']} > {tol_lse} at {res}")
    if fault_at is not None:
        fres = {**{f"{n}_rel": f.rel for n, f in faults.items()},
                **{f"{n}_max_rel": f.max_rel for n, f in faults.items()}}
        emit("planted_faults", s=s, b=b, h=h, d=d, tile_start=fault_at,
             tol_rel=TOL_REL, **fres)
        for name in faults:
            check(fres[f"{name}_rel"] > TOL_REL,
                  f"a dropped tile reads {fres[name + '_rel']} on {name}, "
                  f"within TOL_REL {TOL_REL}: the check cannot see it")
    return res


def phase_kernels() -> dict:
    """Small cases at D=64 and 128 (S=40 and 384, causal and not, rope
    and not: every branch of flash_fwd_sm90) and D=32 (bf16 through the
    mma.sync forward), then the flagship attention shape with a planted
    fault. Returns the flagship shape's readings."""
    cases = [(s, c, r) for s in (384, 40) for c in (True, False)
             for r in (True, False)]
    cases += [(1023, True, True), (1023, True, False)]
    for i, (s, causal, rope) in enumerate(cases):
        check_case(s, causal, rope, seed=i, **SMALL)
        check_case(s, causal, rope, seed=200 + i,
                   **{**SMALL, "d": FLAGSHIP_ATTN["d"]})
    for i, (causal, rope) in enumerate(((True, True), (False, False))):
        check_case(384, causal, rope, seed=220 + i, **{**SMALL, "d": 32})
    check_case(1024, True, True, seed=100, **FLAGSHIP_ATTN)
    return check_case(MAIN_S, True, True, seed=101, fault_at=512,
                      **FLAGSHIP_ATTN)


def phase_kernels_fp32() -> dict:
    """fp32 inputs at the reference's streaming-tier shapes: its
    TestStreamingKernels' (B2 S384 H2 D16, causal x rope) and B1 S8192
    H2 D128, where its fp32 path streams; then the fp32 model's own shape
    (parity_fp32: B1 S8191 H4 D128)."""
    import torch

    for i, (causal, rope) in enumerate((c, r) for c in (True, False)
                                       for r in (True, False)):
        check_case(384, causal, rope, b=2, h=2, d=16, seed=300 + i,
                   dtype=torch.float32)
    check_case(FP32_LONG_S, True, True, seed=310, dtype=torch.float32,
               **LONG_CHECK)
    _free()
    res = check_case(FP32_LONG_S - 1, True, True, seed=311,
                     dtype=torch.float32, chunk=PLAIN_HEADS, **FP32_MODEL_ATTN)
    _free()
    return res


def phase_kernels_long() -> dict:
    """bf16 at every shape the long-context paths give the kernels (B1
    H16 D128 at S=8191 and 16383) and at the S=16384 the times take, the
    plain versions PLAIN_HEADS heads at a time, with a planted fault at
    the middle tile of the long_ctx_xl shape. Returns that shape's
    readings."""
    check_case(LONG_S - 1, True, True, seed=400, chunk=PLAIN_HEADS,
               **XL_ATTN)
    _free()
    check_case(XL_S, True, True, seed=401, chunk=PLAIN_HEADS, **XL_ATTN)
    _free()
    res = check_case(XL_S - 1, True, True, seed=402, chunk=PLAIN_HEADS,
                     fault_at=XL_S // 2, **XL_ATTN)
    _free()
    return res


def planted_faults(args, tile_start) -> dict:
    """What the kernel checks would read for a kernel that drops one
    64-wide tile: the plain versions' outputs on `args` (q, k, v, dout,
    lse, delta, dlse, tables; causal, rope) with keys [tile_start, +64)
    cut from the forward's softmax and from dq's dS.K, and queries
    [tile_start, +64) cut from dk/dv's stream. check_case holds these
    against the plain versions' own outputs: each reading must clear
    TOL_REL, or the check could not see such a fault."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk

    q, k, v, dout = args[:4]
    tables = args[-1]
    t = slice(tile_start, tile_start + fk.BLOCK)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def in_dot(spec, a, x):   # a rounded to the input type, as the kernels
        return torch.einsum(spec, a.to(q.dtype).float(), x.float())

    def unrope(x):
        return fk.rope_rotate(x, *tables, inverse=True).to(q.dtype)

    scores, qr, kr = fk._scores(q, k, tables, True)
    scores[..., t] = fk.NEG_INF
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    del scores
    out = {"out": (in_dot("bhqk,bkhd->bqhd", p, v)
                   / p.sum(-1).permute(0, 2, 1)[..., None]).to(q.dtype)}
    del p
    p, ds, _, _ = fk._probs_and_ds(*args, causal=True)
    ds_k = ds.clone()
    ds_k[..., t] = 0
    out["dq"] = unrope(in_dot("bhqk,bkhd->bqhd", ds_k, kr) * scale)
    del ds_k
    p[..., t, :] = 0
    ds[..., t, :] = 0
    out["dv"] = in_dot("bhqk,bqhd->bkhd", p, dout).to(q.dtype)
    out["dk"] = unrope(in_dot("bhqk,bqhd->bkhd", ds, qr) * scale)
    return out


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


def bounds(b, s, h, d, peak_flops, peak_bytes, elem=2) -> dict:
    """Least time for each kernel's work at this shape: the larger of its
    tensor-core FLOPs (causal pairs only) over `peak_flops` and its
    compulsory bytes (each input read once, each output written once, in
    elements of `elem` bytes) over the memory rate."""
    pairs = b * h * s * (s + 1) // 2
    tile = b * s * h * d * elem       # one [B, S, H, D] operand
    row = b * h * s * 4               # one fp32 [B, H, S] row vector
    tables = 2 * s * d * elem         # cos and sinm, in the input type
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


def time_kernels(label, b, s, h, d, peak_flops, peak_bytes, dtype=None,
                 plain_h=None, inner=10) -> dict:
    """Each kernel at [b, s, h, d] (causal, rope, out-only dlse as on the
    model's path): its CUDA-event time, its bound, its plain version's
    time (at `plain_h` heads where the dense plain version would not fit
    at h) and PyTorch's SDPA forward and backward as the yardstick."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.workloads import _flash_kernels as fk

    dtype = dtype or torch.bfloat16
    plain_h = plain_h or h
    q, k, v, dout, dlse = _inputs(b, s, h, d, seed=7, dtype=dtype)
    dlse.zero_()   # the model's path: out-only consumer
    tables = _tables(s, d, True, dtype)

    def operands(q, k, v, dout, dlse):
        o, lse = fk.fwd(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        return (q, k, v, dout, lse, delta.contiguous(), dlse, tables)

    args = operands(q, k, v, dout, dlse)
    ms = {
        "flash_fwd": time_ms(lambda: fk.fwd(q, k, v, tables, causal=True),
                             inner=inner),
        "flash_bwd_dq": time_ms(lambda: fk.bwd_dq(*args, causal=True),
                                inner=inner),
        "flash_bwd_dkv": time_ms(lambda: fk.bwd_dkv(*args, causal=True),
                                 inner=inner),
    }
    # Yardstick only (the port never calls it): SDPA on the roped inputs,
    # [B, H, S, D] contiguous, forward and backward (dq, dk, dv together).
    qr, kr = (fk.rope_rotate(x, *tables).transpose(1, 2).contiguous()
              for x in (q, k))
    vr = v.transpose(1, 2).contiguous()
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True), inner=inner)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qr, kr, vr))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    do_t = dout.transpose(1, 2).contiguous()
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do_t, retain_graph=True), inner=inner)
    del qr, kr, vr, qg, kg, vg, out, do_t
    if plain_h != h:
        del args, q, k, v, dout, dlse
        _free()
        q, k, v, dout, dlse = _inputs(b, s, plain_h, d, seed=7, dtype=dtype)
        dlse.zero_()
        args = operands(q, k, v, dout, dlse)
    plain_ms = {
        "flash_fwd": time_ms(lambda: fk.fwd_plain(q, k, v, tables,
                                                  causal=True), 3, 1),
        "flash_bwd_dq": time_ms(lambda: fk.bwd_dq_plain(*args, causal=True),
                                3, 1),
        "flash_bwd_dkv": time_ms(lambda: fk.bwd_dkv_plain(*args, causal=True),
                                 3, 1),
    }
    del args, q, k, v, dout, dlse
    _free()
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
               "flash_bwd_dkv": sdpa_bwd}
    elem = torch.empty((), dtype=dtype).element_size()
    bnd = bounds(b, s, h, d, peak_flops, peak_bytes, elem)
    res = {name: {"ms": ms[name], "plain_ms": plain_ms[name],
                  "library_ms": library[name], **bnd[name]} for name in ms}
    emit(label, shape=dict(b=b, s=s, h=h, d=d, causal=True, rope=True,
                           dtype=str(dtype).removeprefix("torch.")),
         plain_shape=dict(b=b, s=s, h=plain_h, d=d),
         sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd,
         peak_flops=peak_flops, peak_bytes_per_s=peak_bytes, kernels=res)
    return res


def phase_times(peak_flops: float, peak_bytes: float) -> dict:
    return time_kernels("times", s=MAIN_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, **FLAGSHIP_ATTN)


def phase_times_xl(peak_flops: float, peak_bytes: float) -> dict:
    return time_kernels("times_xl", s=XL_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, plain_h=LONG_CHECK["h"],
                        inner=3, **XL_ATTN)


def phase_times_fp32(peak_flops: float, peak_bytes: float) -> dict:
    import torch

    return time_kernels("times_fp32", s=FP32_LONG_S, peak_flops=peak_flops,
                        peak_bytes=peak_bytes, dtype=torch.float32,
                        inner=3, **LONG_CHECK)


def check_path_launches(where: str, want: int) -> dict:
    """The launch counts since the last reset on a bf16 model path: each
    wrapper `want` times (n_layers x step calls), every forward through
    flash_fwd_sm90 and none through the mma.sync forward. Returns the
    per-kernel counts."""
    from tpu_dra_torch.workloads import _flash_kernels as fk

    per_wrapper, per_kernel = fk.launches(), fk.kernel_launches()
    for name, n in per_wrapper.items():
        check(n == want, f"{name} launched {n} times in {where}, want "
                         f"n_layers x steps = {want}")
    for name, n in per_kernel.items():
        expect = want if name in MODEL_PATH_KERNELS else 0
        check(n == expect, f"kernel {name} launched {n} times in {where}, "
                           f"want {expect}")
    return per_kernel


def phase_main_path() -> tuple[dict, dict]:
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _flash_kernels as fk

    fk.reset_launches()
    res = bench.bench_mfu(steps=5)
    emit("main", launches=fk.launches(),
         kernel_launches=fk.kernel_launches(), **res)
    check(math.isfinite(res["loss"]), f"non-finite loss {res['loss']}")
    counts = check_path_launches("the main path",
                                 res["n_layers"] * res["step_calls"])
    return res, counts


def phase_long_context() -> dict:
    """bench_long_context at S=8192 and at S=16384, as bench.py's TPU
    phase calls it, each with the launch counts zeroed just before and
    read just after. Returns the S=16384 run's counts."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads import _flash_kernels as fk

    counts = {}
    for steps, seq, prefix in ((4, LONG_S, "long_ctx"),
                               (3, XL_S, "long_ctx_xl")):
        fk.reset_launches()
        res = bench.bench_long_context(steps=steps, seq=seq, prefix=prefix)
        _free()
        emit("long_ctx", launches=fk.launches(),
             kernel_launches=fk.kernel_launches(), **res)
        check(math.isfinite(res["loss"]), f"non-finite {prefix} loss")
        counts = check_path_launches(prefix,
                                     res["n_layers"] * res["step_calls"])
    return counts


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


def phase_model_parity_fp32(seed=3) -> dict:
    """An fp32 model at S=8192 on the card: the kernel path (the fp32
    kernels, counted) against the same path on the kernels' plain
    versions, whose only difference is summation order."""
    import torch

    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads.model import ModelConfig, init_params

    base = dict(vocab=1024, d_model=512, n_heads=4, n_layers=2, d_ff=1024,
                max_seq=FP32_LONG_S, dtype=torch.float32)
    params = init_params(ModelConfig(**base),
                         torch.Generator().manual_seed(seed), "cuda")
    tokens = torch.randint(
        0, base["vocab"], (1, base["max_seq"]),
        generator=torch.Generator().manual_seed(seed + 1000)).cuda()
    fk.reset_launches()
    lk, loss_k, gk, names = _model_run(base, params, tokens, "auto")
    counts = fk.kernel_launches()
    check(math.isfinite(loss_k) and bool(torch.isfinite(lk).all()),
          "non-finite fp32 kernel-path logits or loss")
    # Two forwards (logits, loss), through the mma.sync forward, and one
    # backward per layer.
    want = {"flash_fwd_sm90": 0, "flash_fwd": 2 * base["n_layers"],
            "flash_bwd_dq": base["n_layers"],
            "flash_bwd_dkv": base["n_layers"]}
    check(counts == want, f"fp32 model launches {counts}, want {want}")
    with plain_kernels():
        lr, loss_r, gr, _ = _model_run(base, params, tokens, "flash")
    logits_rel = float((lk - lr).norm() / lr.norm())
    grad_rel = {n: _max_rel(a, b) for n, a, b in zip(names, gk, gr)}
    worst = max(grad_rel, key=grad_rel.get)
    res = dict(seed=seed, against="plain", logits_rel=logits_rel,
               loss_kernel=loss_k, loss_against=loss_r, worst_grad=worst,
               worst_grad_rel=grad_rel[worst], launches=counts)
    emit("parity_fp32", config={**base, "dtype": "float32"}, **res,
         grad_rel=grad_rel)
    check(logits_rel <= TOL_LOGITS_FP32, f"fp32 logits rel {res}")
    check(grad_rel[worst] <= TOL_GRAD_FP32, f"fp32 grad rel {res}")
    del lk, gk, lr, gr, params
    _free()
    return res


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
    phase_kernels_fp32()
    long_bf16 = phase_kernels_long()
    # Bounds are against the H100 SXM's published peaks (700 W). fp32
    # runs three TF32 products per product: a third of the TF32 peak.
    peak_bf16 = gpuinfo.PEAK_BF16_TFLOPS[H100_SXM] * 1e12
    peak_bytes = gpuinfo.PEAK_HBM_BYTES_PER_S[H100_SXM]
    times = phase_times(peak_bf16, peak_bytes)
    times_xl = phase_times_xl(peak_bf16, peak_bytes)
    phase_times_fp32(gpuinfo.PEAK_TF32_TFLOPS[H100_SXM] * 1e12 / 3,
                     peak_bytes)
    _, counts = phase_main_path()
    _free()
    counts_xl = phase_long_context()
    phase_model_parity()
    phase_model_parity_fp32()

    def max_err(res):
        return {"flash_fwd": res["out_abs"], "flash_bwd_dq": res["dq_abs"],
                "flash_bwd_dkv": max(res["dk_abs"], res["dv_abs"])}

    wrappers = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    rows = {  # entry name -> (times, launches, max_abs_err)
        **{name: (times, counts, max_err(flagship)) for name in wrappers},
        **{name + "_xl": (times_xl, counts_xl, max_err(long_bf16))
           for name in wrappers},
    }
    kernels = []
    for entry, wrapper, kname, replaces in TPU_KERNELS:
        t_all, cnt, err = rows[entry]
        t = t_all[wrapper]
        kernels.append({
            "name": entry, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": cnt[kname],
            "max_abs_err": err[wrapper], "ms": t["ms"],
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
