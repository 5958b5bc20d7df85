"""Build, load and launch the hand-written CUDA flash-attention kernels.

Five kernels, one per source under ``csrc/`` (see each source's header
for the TPU kernels it replaces, what bounds it on the H100 and what its
design does about that). Each streams its non-stationary side through
shared memory at every sequence length, so each is the counterpart of
resident TPU kernels and of their streaming (XL) twins:

- ``flash_fwd_sm90`` (csrc/flash_fwd_sm90.cu) and ``flash_fwd``
  (csrc/flash_fwd.cu) replace ``_fwd_kernel`` and ``_fwd_stream_kernel``.
  ``fwd_route`` picks one per (dtype, D): bf16 at D in
  ``FWD_SM90_HEAD_DIMS`` (64, 128: every forward of the model paths) runs
  the Hopper kernel (128-row Q tiles, TMA ring, warp-specialised wgmma);
  fp32, and bf16 at the other head dims, run ``flash_fwd`` (64-row Q
  tiles, mma.sync);
- ``flash_bwd_sm90`` (csrc/flash_bwd_sm90.cu) replaces ``_bwd_dq_kernel``,
  ``_bwd_dkv_kernel`` and their streaming twins in one fused pass, and
  ``flash_bwd_dq`` (csrc/flash_bwd_dq.cu) with ``flash_bwd_dkv``
  (csrc/flash_bwd_dkv.cu) replace them as a pair. ``bwd_route`` picks
  per (dtype, D): bf16 at D in ``BWD_SM90_HEAD_DIMS`` (64, 128: every
  backward of the model paths) runs the fused Hopper kernel (128-key
  K/V tiles, TMA ring, warp-specialised wgmma, fp32 dQ accumulator);
  fp32, and bf16 at the other head dims, run the pair (64-row tiles,
  mma.sync)
  (all in tpu_dra/workloads/flashattention.py).

They take bf16 or fp32 inputs (``KERNEL_DTYPES``). fp32 products run as
three TF32 tensor-core products each, to fp32 accuracy
(csrc/flash_common.cuh says why).

Build: ``nvcc`` compiles each source, all at once, into its own shared
library with a plain C interface under ``build/tpu_dra_torch/`` at the
repository root (listed in .gitignore), at first use. File names carry a
hash of the sources and flags, so an edit rebuilds. The libraries are
loaded with ``ctypes``; every pointer and the stream are ``c_void_p``.

Each wrapper (``fwd``, ``bwd``, ``bwd_dq``, ``bwd_dkv``) takes
[B, S, H, D] tensors. For CPU tensors it runs its plain PyTorch version
beside it in this module (``fwd_plain``, ``bwd_plain``, ``bwd_dq_plain``,
``bwd_dkv_plain``); for CUDA tensors it launches its kernel on the
current stream (``bwd`` the fused kernel, or ``bwd_dq`` then ``bwd_dkv``),
adds one to its ``launches`` count (``fwd`` and ``bwd`` also to
``route_launches[route]``), and raises if the launch fails. There is no
other path: no fallback from a failed build or launch, and none from one
route to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import torch

from tpu_dra_torch.native import gpuinfo

NEG_INF = -1e30
# Rows per tile of every kernel (stationary and streamed side alike).
BLOCK = 64
MAX_HEAD_DIM = 128
# What the kernels take, and the element size each is told.
KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}
# The head dims the fp32 instances are built for (csrc/flash_common.cuh,
# dispatch_head_dim): the reference's streaming-tier test shape and the
# flagship's. bf16 takes every multiple of 16 up to MAX_HEAD_DIM.
FP32_HEAD_DIMS = (16, 128)
# The head dims the Hopper forward (csrc/flash_fwd_sm90.cu) is built for,
# in bf16.
FWD_SM90_HEAD_DIMS = (64, 128)
# The forward kernel of each route.
FWD_KERNELS = {"sm90": "flash_fwd_sm90", "mma": "flash_fwd"}
# The head dims the fused Hopper backward (csrc/flash_bwd_sm90.cu) is
# built for, in bf16, and the backward kernels of each route.
BWD_SM90_HEAD_DIMS = (64, 128)
BWD_KERNELS = {"sm90": ("flash_bwd_sm90",),
               "mma": ("flash_bwd_dq", "flash_bwd_dkv")}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_dra_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
# B S H D, in strides, causal, rope, element bytes
_SHAPE = [_INT] * 4 + [_I64] * 3 + [_INT] * 3
ARGTYPES = {
    "flash_fwd": [_PTR] * 7 + _SHAPE + [_PTR],
    "flash_fwd_sm90": [_PTR] * 7 + _SHAPE + [_PTR],
    "flash_bwd_dq": [_PTR] * 10 + _SHAPE + [_PTR],
    "flash_bwd_dkv": [_PTR] * 11 + _SHAPE + [_PTR],
    "flash_bwd_sm90": [_PTR] * 13 + _SHAPE + [_PTR],
}

_loaded: dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every kernel source that has no library for the current
    sources yet, one nvcc per source, all started together. Returns
    {kernel name: library path}; raises with the compilers' output if
    any source fails."""
    nvcc = gpuinfo.nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: BUILD_DIR / f"lib{src.stem}_{digest}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    log = []
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        log.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
        else:
            tmp.replace(lib)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return libs


def _lib(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        libs = build()
        for stem, path in libs.items():
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, stem)
            fn.argtypes = ARGTYPES[stem]
            fn.restype = ctypes.c_int
            _loaded[stem] = lib
    return _loaded[name]


def _call(name: str, *args) -> None:
    err = getattr(_lib(name), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# The rotation, shared by the plain versions and flashattention.py
# ---------------------------------------------------------------------------

def rope_rotate(x: torch.Tensor, cos_t: torch.Tensor, sinm_t: torch.Tensor,
                *, inverse: bool = False) -> torch.Tensor:
    """x [B, S, H, D] rotated by the [S, D] tables (position = row):
    x * cos + roll(x, D/2) * sinm in fp32, x.dtype out — the TPU kernels'
    _rope_apply. inverse=True applies the transpose rotation (-sinm), the
    VJP of the forward one."""
    sinm = -sinm_t if inverse else sinm_t
    xf = x.float()
    rolled = torch.roll(xf, x.shape[-1] // 2, dims=-1)
    return (xf * cos_t[:, None, :] + rolled * sinm[:, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' functions, one dense pass each)
# ---------------------------------------------------------------------------

def _scores(q, k, tables, causal):
    """Scaled fp32 scores [B, H, S, S] of (roped) q and k, masked with the
    finite NEG_INF, plus the roped operands in the input dtype."""
    if tables is not None:
        q, k = rope_rotate(q, *tables), rope_rotate(k, *tables)
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    return scores, q, k


def fwd_plain(q, k, v, tables, *, causal):
    """(o [B, S, H, D], lse [B, H, S] fp32). Unnormalized p is rounded to
    the input dtype before P.V and the sum is divided after, as in the
    kernel."""
    scores, _, _ = _scores(q, k, tables, causal)
    row_max = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - row_max)
    denom = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / denom.permute(0, 2, 1)[..., None]
    return o.to(q.dtype), row_max[..., 0] + torch.log(denom)


def _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables, causal):
    scores, qr, kr = _scores(q, k, tables, causal)
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp + (dlse - delta)[..., None])
    return p, ds, qr, kr


def bwd_dq_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal):
    """dq [B, S, H, D]: scale * dS . K with dS rounded to the input dtype,
    then the inverse rotation."""
    _, ds, _, kr = _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables,
                                 causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), kr.float())
    dq = dq * (1.0 / math.sqrt(q.shape[-1]))
    if tables is not None:
        dq = rope_rotate(dq, *tables, inverse=True)
    return dq.to(q.dtype)


def bwd_dkv_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal):
    """(dk, dv) [B, S, H, D]: dV = P^T . dO; dK = scale * dS^T . Q, then
    the inverse rotation; P and dS rounded to the input dtype."""
    p, ds, qr, _ = _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables,
                                 causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(k.dtype).float(), qr.float())
    dk = dk * (1.0 / math.sqrt(q.shape[-1]))
    if tables is not None:
        dk = rope_rotate(dk, *tables, inverse=True)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal):
    """(dq, dk, dv): bwd_dq_plain and bwd_dkv_plain on the same operands,
    the plain version of the fused backward."""
    args = (q, k, v, dout, lse, delta, dlse, tables)
    return (bwd_dq_plain(*args, causal=causal),
            *bwd_dkv_plain(*args, causal=causal))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _aligned(x: torch.Tensor) -> bool:
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in x.stride()[:-1]))


def _kernel_inputs(q, k, v, tables):
    """Check what the kernels take and return (q, k, v, tables) as they
    take them: all bf16 or all fp32 on one card, D a multiple of 16 up to
    128 (fp32: one of FP32_HEAD_DIMS), q/k/v sharing one 16-byte-aligned
    layout (views of one fused projection pass as they are; anything else
    is made contiguous), and the rope tables in q's dtype."""
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA flash kernels take bfloat16 or float32, got "
                        f"{q.dtype}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share a [B, S, H, D] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    d = q.shape[-1]
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernels take multiples of 16 up "
                         f"to {MAX_HEAD_DIM}")
    if q.dtype == torch.float32 and d not in FP32_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the fp32 kernels are built for "
                         f"{FP32_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.stride() == k.stride() == v.stride()
            and all(_aligned(x) for x in (q, k, v))):
        q, k, v = (x.contiguous() for x in (q, k, v))
    if tables is not None:
        tables = tuple(t.to(device=q.device, dtype=q.dtype).contiguous()
                       for t in tables)
    return q, k, v, tables


def _table_ptrs(tables):
    return (None, None) if tables is None else (tables[0].data_ptr(),
                                                tables[1].data_ptr())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _dims(q, causal, tables):
    """The shape arguments every kernel takes after its pointers."""
    b, s, h, d = q.shape
    st = q.stride()
    return (b, s, h, d, st[0], st[1], st[2], int(causal),
            int(tables is not None), KERNEL_DTYPES[q.dtype])


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash kernel for device {x.device}")
    return x.device.type


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel that serves (dtype, D): "sm90" (flash_fwd_sm90:
    bf16 at D in FWD_SM90_HEAD_DIMS) or "mma" (flash_fwd: fp32, and bf16
    at the other head dims). wgmma takes fp32 only as TF32 with both
    operands K-major, and P.V needs V MN-major, so fp32 keeps the 3xTF32
    mma.sync kernel."""
    if dtype == torch.bfloat16 and d in FWD_SM90_HEAD_DIMS:
        return "sm90"
    return "mma"


def fwd(q, k, v, tables, *, causal: bool):
    """(o [B, S, H, D], lse [B, H, S] fp32) of attention over q, k, v
    ([B, S, H, D]); tables = the [S, D] (cos, sinm) rope tables, or None
    for no rope."""
    if _device_of(q) == "cpu":
        return fwd_plain(q, k, v, tables, causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    b, s, h, d = q.shape
    route = fwd_route(q.dtype, d)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _call(FWD_KERNELS[route], q.data_ptr(), k.data_ptr(), v.data_ptr(),
              *_table_ptrs(tables), o.data_ptr(), lse.data_ptr(),
              *_dims(q, causal, tables), _stream(q))
    fwd.launches += 1
    fwd.route_launches[route] += 1
    return o, lse


def _bwd_inputs(q, dout, lse, delta, dlse):
    b, s, h, d = q.shape
    if dout.shape != (b, s, h, d) or lse.shape != (b, h, s) \
            or delta.shape != (b, h, s) or dlse.shape != (b, h, s):
        raise ValueError("backward operands do not match q's [B, S, H, D]")
    dout = dout.to(q.dtype).contiguous()
    return (dout,) + tuple(x.float().contiguous() for x in (lse, delta, dlse))


def bwd_dq(q, k, v, dout, lse, delta, dlse, tables, *, causal: bool):
    """dq [B, S, H, D]; dout [B, S, H, D]; lse, delta = rowsum(dO * O) and
    dlse (the lse cotangent) [B, H, S] fp32."""
    if _device_of(q) == "cpu":
        return bwd_dq_plain(q, k, v, dout, lse, delta, dlse, tables,
                            causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    dout, lse, delta, dlse = _bwd_inputs(q, dout, lse, delta, dlse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dlse.data_ptr(), *_table_ptrs(tables), dq.data_ptr(),
              *_dims(q, causal, tables), _stream(q))
    bwd_dq.launches += 1
    return dq


def bwd_dkv(q, k, v, dout, lse, delta, dlse, tables, *, causal: bool):
    """(dk, dv) [B, S, H, D]; operands as bwd_dq."""
    if _device_of(q) == "cpu":
        return bwd_dkv_plain(q, k, v, dout, lse, delta, dlse, tables,
                             causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    dout, lse, delta, dlse = _bwd_inputs(q, dout, lse, delta, dlse)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dlse.data_ptr(), *_table_ptrs(tables), dk.data_ptr(),
              dv.data_ptr(), *_dims(q, causal, tables), _stream(q))
    bwd_dkv.launches += 1
    return dk, dv


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward that serves (dtype, D): "sm90" (flash_bwd_sm90, one
    fused pass: bf16 at D in BWD_SM90_HEAD_DIMS) or "mma" (flash_bwd_dq
    then flash_bwd_dkv: fp32, and bf16 at the other head dims). As in
    fwd_route, wgmma takes fp32 only as TF32 with both operands K-major,
    and the fused pass reads dO, Q, dS and K MN-major."""
    if dtype == torch.bfloat16 and d in BWD_SM90_HEAD_DIMS:
        return "sm90"
    return "mma"


def bwd(q, k, v, dout, lse, delta, dlse, tables, *, causal: bool):
    """(dq, dk, dv) [B, S, H, D] of attention over q, k, v; dout
    [B, S, H, D]; lse, delta = rowsum(dO * O) and dlse (the lse
    cotangent) [B, H, S] fp32; tables as fwd's."""
    if _device_of(q) == "cpu":
        return bwd_plain(q, k, v, dout, lse, delta, dlse, tables,
                         causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    route = bwd_route(q.dtype, q.shape[-1])
    if route == "mma":
        args = (q, k, v, dout, lse, delta, dlse, tables)
        out = (bwd_dq(*args, causal=causal),
               *bwd_dkv(*args, causal=causal))
    else:
        dout, lse, delta, dlse = _bwd_inputs(q, dout, lse, delta, dlse)
        # dQ's fp32 accumulator: every K tile's CTA adds into it.
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                      for _ in range(3))
        with torch.cuda.device(q.device):
            _call("flash_bwd_sm90", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dlse.data_ptr(), *_table_ptrs(tables), dq_acc.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  *_dims(q, causal, tables), _stream(q))
        out = (dq, dk, dv)
    bwd.launches += 1
    bwd.route_launches[route] += 1
    return out


fwd.launches = 0
fwd.route_launches = dict.fromkeys(FWD_KERNELS, 0)
bwd.launches = 0
bwd.route_launches = dict.fromkeys(BWD_KERNELS, 0)
bwd_dq.launches = 0
bwd_dkv.launches = 0
WRAPPERS = {"flash_fwd": fwd, "flash_bwd": bwd, "flash_bwd_dq": bwd_dq,
            "flash_bwd_dkv": bwd_dkv}


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    WRAPPERS["flash_fwd"].route_launches = dict.fromkeys(FWD_KERNELS, 0)
    WRAPPERS["flash_bwd"].route_launches = dict.fromkeys(BWD_KERNELS, 0)


def launches() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def kernel_launches() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset_launches(): the
    forward's by route (FWD_KERNELS), the fused backward's as its route
    counts it, and the pair's as their wrappers count them (the "mma"
    route of ``bwd`` calls both)."""
    routes = WRAPPERS["flash_fwd"].route_launches
    counts = {FWD_KERNELS[route]: n for route, n in routes.items()}
    counts["flash_bwd_sm90"] = WRAPPERS["flash_bwd"].route_launches["sm90"]
    counts.update((name, WRAPPERS[name].launches)
                  for name in BWD_KERNELS["mma"])
    return counts
