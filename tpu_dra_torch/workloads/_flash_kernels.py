"""The hand-written CUDA flash-attention kernels: their routes, C entry
points, wrappers and plain PyTorch versions.

Four kernels, one per source under ``csrc/`` (see each source's header
for the TPU kernels it replaces, what bounds it on the H100 and what its
design does about that). Each streams its non-stationary side through
shared memory at every sequence length, so each is the counterpart of
resident TPU kernels and of their streaming (XL) twins:

- ``flash_fwd_sm90`` (csrc/flash_fwd_sm90.cu) and ``flash_fwd``
  (csrc/flash_fwd.cu) replace ``_fwd_kernel`` and ``_fwd_stream_kernel``;
- ``flash_bwd_sm90`` (csrc/flash_bwd_sm90.cu) and ``flash_bwd_mma``
  (csrc/flash_bwd_mma.cu) each replace ``_bwd_dq_kernel``,
  ``_bwd_dkv_kernel`` and their streaming twins in one fused pass that
  adds dQ into an fp32 accumulator
  (all in tpu_dra/workloads/flashattention.py).

``route`` picks one route per (dtype, D, Dv) for both directions: bf16
at D in ``SM90_HEAD_DIMS`` (64, 128: every model path), or at a (q.k, v)
pair of ``SM90_SPLIT_HEAD_DIMS`` ((192, 128): the latent attention of
dsv3_model.py, no fused rope), runs the Hopper kernels ("sm90": TMA ring,
warp-specialised wgmma; 128-row Q tiles forward, 128-key K/V tiles
backward); fp32, and bf16 at the other head dims, run the mma.sync
kernels ("mma": cp.async ring; 64-row Q tiles forward, with rope a first
launch writing the roped k into a scratch buffer the wrapper allocates;
64-key K/V tiles backward). ``FWD_KERNELS`` and ``BWD_KERNELS`` name each
direction's kernel per route.

They take bf16 or fp32 inputs (``KERNEL_DTYPES``). fp32 products run as
three TF32 tensor-core products each, to fp32 accuracy
(csrc/flash_common.cuh says why). _cuda.py builds, loads and launches
them; this module declares their entry points there.

Each wrapper (``fwd``, ``bwd``) takes [B, S, H, D] tensors (v, o, dO and
dV [B, S, H, Dv], Dv = D but at a split pair). For CPU
tensors it runs its plain PyTorch version beside it in this module
(``fwd_plain``, ``bwd_plain``, the latter built of ``bwd_dq_plain`` and
``bwd_dkv_plain``); for CUDA tensors it launches its route's kernel on
the current stream (_cuda.launch, which counts it under the kernel's
name). There is no other path: no fallback from a failed build or
launch, and none from one route to the other.
"""

from __future__ import annotations

import math

import torch

from tpu_dra_torch.workloads import _cuda

NEG_INF = -1e30
# The length rule of non-causal attention (flashattention.py): S a
# multiple of BLOCK, or at most BLOCK, as the reference refuses lengths
# its blocks do not divide. The mma.sync kernels tile 64 rows; the
# Hopper kernels tile 128 and mask keys past S in every mode.
BLOCK = 64
MAX_HEAD_DIM = 128
# What the kernels take, and the element size each is told.
KERNEL_DTYPES = {torch.bfloat16: 2, torch.float32: 4}
# The head dims the fp32 instances are built for (csrc/flash_common.cuh,
# dispatch_head_dim): the reference's streaming-tier test shape and the
# flagship's. bf16 takes every multiple of 16 up to MAX_HEAD_DIM.
FP32_HEAD_DIMS = (16, 128)
# The head dims both Hopper kernels (csrc/flash_{fwd,bwd}_sm90.cu) are
# built for, in bf16.
SM90_HEAD_DIMS = (64, 128)
# The (q.k, v) head-dim pairs both Hopper kernels are built for besides,
# in bf16 and without fused rope: multi-head latent attention (DeepSeek-
# V2/V3), 128 "nope" + 64 roped dims for q and k, 128 for v. Only the
# Hopper route takes them.
SM90_SPLIT_HEAD_DIMS = ((192, 128),)
# Each direction's kernel (C entry point) per route.
FWD_KERNELS = {"sm90": "flash_fwd_sm90", "mma": "flash_fwd"}
BWD_KERNELS = {"sm90": "flash_bwd_sm90", "mma": "flash_bwd_mma"}

_PTR, _INT, _I64 = _cuda.PTR, _cuda.INT, _cuda.I64
# B S H D Dv, q/k's strides, v's strides, causal, rope, element bytes
_SHAPE = [_INT] * 5 + [_I64] * 6 + [_INT] * 3
# Each source's one entry, named after it; the stream last.
ARGTYPES = {
    # flash_fwd_sm90's operands, then the roped-k scratch.
    "flash_fwd": [_PTR] * 8 + _SHAPE + [_PTR],
    "flash_fwd_sm90": [_PTR] * 7 + _SHAPE + [_PTR],
    "flash_bwd_sm90": [_PTR] * 13 + _SHAPE + [_PTR],
    "flash_bwd_mma": [_PTR] * 13 + _SHAPE + [_PTR],
}
_cuda.declare({stem: {stem: args} for stem, args in ARGTYPES.items()})


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
    is made contiguous), and the rope tables in q's dtype. At a split pair
    of SM90_SPLIT_HEAD_DIMS (bf16, no tables) v's head dim differs, q and
    k share one aligned layout and v has its own."""
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA flash kernels take bfloat16 or float32, got "
                        f"{q.dtype}")
    if q.dim() == 4 and q.shape == k.shape and v.shape[:3] == q.shape[:3] \
            and (q.shape[-1], v.shape[-1]) in SM90_SPLIT_HEAD_DIMS:
        return _split_inputs(q, k, v, tables)
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


def _split_inputs(q, k, v, tables):
    """_kernel_inputs at a split head-dim pair: bf16 only, no rope tables
    (the caller ropes the rotated dims), q and k sharing one aligned
    layout (else both made contiguous) and v aligned in its own."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"head dims {(q.shape[-1], v.shape[-1])}: the "
                        f"kernels take bfloat16 only, got {q.dtype}")
    if tables is not None:
        raise ValueError(f"head dims {(q.shape[-1], v.shape[-1])}: no fused "
                         "rope (rotate the roped dims before the call)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.stride() == k.stride() and _aligned(q) and _aligned(k)):
        q, k = q.contiguous(), k.contiguous()
    if not _aligned(v):
        v = v.contiguous()
    return q, k, v, None


def _table_ptrs(tables):
    return (None, None) if tables is None else (tables[0].data_ptr(),
                                                tables[1].data_ptr())


def _dims(q, causal, tables, v=None):
    """The shape arguments every kernel takes after its pointers: v (by
    default q) gives Dv and its own strides."""
    v = q if v is None else v
    b, s, h, d = q.shape
    st, vst = q.stride(), v.stride()
    return (b, s, h, d, v.shape[-1], st[0], st[1], st[2], vst[0], vst[1],
            vst[2], int(causal), int(tables is not None),
            KERNEL_DTYPES[q.dtype])


def route(dtype: torch.dtype, d: int, dv: int = None) -> str:
    """The route that serves (dtype, D, Dv) in both directions: "sm90"
    (flash_fwd_sm90, flash_bwd_sm90: bf16 at D = Dv in SM90_HEAD_DIMS or
    at a pair of SM90_SPLIT_HEAD_DIMS) or "mma" (flash_fwd,
    flash_bwd_mma: fp32, and bf16 at the other head dims). wgmma takes
    fp32 only as TF32 with both operands K-major, and the forward's P.V
    reads V, the backward dO, Q, dS and K, MN-major, so fp32 keeps the
    3xTF32 mma.sync kernels."""
    dv = d if dv is None else dv
    if dtype == torch.bfloat16 and ((d == dv and d in SM90_HEAD_DIMS)
                                    or (d, dv) in SM90_SPLIT_HEAD_DIMS):
        return "sm90"
    return "mma"


def fwd(q, k, v, tables, *, causal: bool):
    """(o [B, S, H, D], lse [B, H, S] fp32) of attention over q, k, v
    ([B, S, H, D]); tables = the [S, D] (cos, sinm) rope tables, or None
    for no rope."""
    if _cuda.device_of(q, "flash") == "cpu":
        return fwd_plain(q, k, v, tables, causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    b, s, h, d = q.shape
    kernel = FWD_KERNELS[route(q.dtype, d, v.shape[-1])]
    o = torch.empty((b, s, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), *_table_ptrs(tables),
            o.data_ptr(), lse.data_ptr()]
    if kernel == "flash_fwd":
        # flash_fwd's first launch writes the roped k here.
        kr = None if tables is None else torch.empty_like(o)
        ptrs.append(None if kr is None else kr.data_ptr())
    _cuda.launch(kernel, q, *ptrs, *_dims(q, causal, tables, v))
    return o, lse


def _bwd_inputs(q, v, dout, lse, delta, dlse):
    b, s, h, _ = q.shape
    if dout.shape != v.shape or lse.shape != (b, h, s) \
            or delta.shape != (b, h, s) or dlse.shape != (b, h, s):
        raise ValueError("backward operands do not match q's [B, S, H, D]")
    dout = dout.to(q.dtype).contiguous()
    return (dout,) + tuple(x.float().contiguous() for x in (lse, delta, dlse))


def bwd(q, k, v, dout, lse, delta, dlse, tables, *, causal: bool):
    """(dq, dk [B, S, H, D], dv [B, S, H, Dv]) of attention over q, k, v;
    dout [B, S, H, Dv]; lse, delta = rowsum(dO * O) and dlse (the lse
    cotangent) [B, H, S] fp32; tables as fwd's."""
    if _cuda.device_of(q, "flash") == "cpu":
        return bwd_plain(q, k, v, dout, lse, delta, dlse, tables,
                         causal=causal)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    kernel = BWD_KERNELS[route(q.dtype, q.shape[-1], v.shape[-1])]
    dout, lse, delta, dlse = _bwd_inputs(q, v, dout, lse, delta, dlse)
    # dQ's fp32 accumulator: every K tile's CTA adds into it.
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _cuda.launch(kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dlse.data_ptr(), *_table_ptrs(tables), dq_acc.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *_dims(q, causal, tables, v))
    return dq, dk, dv
