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
dV [B, S, H, Dv], Dv = D but at a split pair). At a pair of
``SM90_SPLIT_HEAD_DIMS`` ((192, 128), bf16, the Hopper route) k and v may
hold Hkv heads, a divisor of H (grouped-query attention: query head h
reads K/V head h // (H / Hkv); dK and dV come back [B, S, Hkv, *]), and a
causal call may take a sliding window W (query i sees keys j with
i - W < j <= i); every other input takes neither, and a group or window
it is given raises. A grouped call with no window runs the fused
Hopper backward split (``split_dkv``): one CTA per (K tile, query head),
whose fp32 dK and dV are reduce-added, so that call's dk and dv, like
every dq, are summed in an order that changes from run to run. For CPU
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

from tpu_dra_torch.infra import trace
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
# Hopper route takes them, and only at them grouped K/V heads and a
# sliding window (MiMo-V2-Flash's attention, mimo_model.py).
SM90_SPLIT_HEAD_DIMS = ((192, 128),)
# Each direction's kernel (C entry point) per route.
FWD_KERNELS = {"sm90": "flash_fwd_sm90", "mma": "flash_fwd"}
BWD_KERNELS = {"sm90": "flash_bwd_sm90", "mma": "flash_bwd_mma"}
# Keys of the stationary K/V tile of one flash_bwd_sm90 CTA (kKeys).
SM90_BWD_KEYS = 128

_PTR, _INT, _I64 = _cuda.PTR, _cuda.INT, _cuda.I64
# B S H Hkv D Dv, q's, k's and v's strides, causal, window, rope,
# element bytes
_SHAPE = [_INT] * 6 + [_I64] * 9 + [_INT] * 4
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

def expand_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """x [B, S, Hkv, D] as [B, S, heads, D]: query head h reads K/V head
    h // (heads / Hkv). The plain versions' form of grouped-query
    attention (the kernels read the Hkv heads where they are)."""
    group = heads // x.shape[2]
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def sum_groups(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """x [B, S, H, D] summed over each K/V head's H / kv_heads query
    heads: [B, S, kv_heads, D], in x's dtype."""
    b, s, h, d = x.shape
    if h == kv_heads:
        return x
    return x.view(b, s, kv_heads, h // kv_heads, d).sum(3)


def band_mask(s: int, window: int, device=None) -> torch.Tensor:
    """[S, S] bool, True where query i sees key j: j <= i, and with a
    window W > 0 also i - j < W."""
    ones = torch.ones(s, s, dtype=torch.bool, device=device)
    keep = ones.tril()
    return keep & ~ones.tril(-window) if window else keep


def _scores(q, k, tables, causal, window=0):
    """Scaled fp32 scores [B, H, S, S] of (roped) q and k, masked with the
    finite NEG_INF, plus the roped operands in the input dtype (k at its
    own Hkv heads)."""
    if tables is not None:
        q, k = rope_rotate(q, *tables), rope_rotate(k, *tables)
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          expand_heads(k, q.shape[2]).float())
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        keep = band_mask(s, window, q.device)
        scores = scores.masked_fill(~keep, NEG_INF)
    return scores, q, k


def fwd_plain(q, k, v, tables, *, causal, window=0):
    """(o [B, S, H, Dv], lse [B, H, S] fp32); k and v may hold fewer heads
    (expand_heads), and a causal call a window. Unnormalized p is rounded
    to the input dtype before P.V and the sum is divided after, as in the
    kernel."""
    scores, _, _ = _scores(q, k, tables, causal, window)
    row_max = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - row_max)
    denom = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       expand_heads(v, q.shape[2]).float())
    o = acc / denom.permute(0, 2, 1)[..., None]
    return o.to(q.dtype), row_max[..., 0] + torch.log(denom)


def _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables, causal,
                  window=0):
    scores, qr, kr = _scores(q, k, tables, causal, window)
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(),
                      expand_heads(v, q.shape[2]).float())
    ds = p * (dp + (dlse - delta)[..., None])
    return p, ds, qr, kr


def bwd_dq_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal,
                 window=0):
    """dq [B, S, H, D]: scale * dS . K with dS rounded to the input dtype,
    then the inverse rotation."""
    _, ds, _, kr = _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables,
                                 causal, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(),
                      expand_heads(kr, q.shape[2]).float())
    dq = dq * (1.0 / math.sqrt(q.shape[-1]))
    if tables is not None:
        dq = rope_rotate(dq, *tables, inverse=True)
    return dq.to(q.dtype)


def bwd_dkv_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal,
                  window=0):
    """(dk [B, S, Hkv, D], dv [B, S, Hkv, Dv]): dV = P^T . dO; dK = scale
    * dS^T . Q, then the inverse rotation; P and dS rounded to the input
    dtype, each K/V head's query heads summed in fp32 and rounded once,
    as the fused kernel accumulates them."""
    p, ds, qr, _ = _probs_and_ds(q, k, v, dout, lse, delta, dlse, tables,
                                 causal, window)
    hkv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(k.dtype).float(), qr.float())
    dv, dk = sum_groups(dv, hkv), sum_groups(dk, hkv)
    dk = dk * (1.0 / math.sqrt(q.shape[-1]))
    if tables is not None:
        dk = rope_rotate(dk, *tables, inverse=True)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_plain(q, k, v, dout, lse, delta, dlse, tables, *, causal, window=0):
    """(dq, dk, dv): bwd_dq_plain and bwd_dkv_plain on the same operands,
    the plain version of the fused backward."""
    args = (q, k, v, dout, lse, delta, dlse, tables)
    return (bwd_dq_plain(*args, causal=causal, window=window),
            *bwd_dkv_plain(*args, causal=causal, window=window))


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal window W keeps over S positions, one
    head: sum over i of min(i + 1, W)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def fwd_tiles(s: int, window: int, rows: int = 128) -> int:
    """(Q tile, K tile) pairs flash_fwd_sm90 visits for one head of a
    causal call over S positions, by its own bounds: Q tile qt reads key
    tiles from max(0, qt * rows - W + 1) // rows (0 with no window) up to
    qt."""
    n = -(-s // rows)
    return sum(qt + 1 - (max(0, qt * rows - window + 1) // rows
                         if window else 0) for qt in range(n))


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
    if q.dim() == 4 and k.dim() == 4 and k.shape[:2] == q.shape[:2] \
            and k.shape[-1] == q.shape[-1] and v.shape[:3] == k.shape[:3] \
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
    (the caller ropes the rotated dims), k and v at H or at a divisor of
    H heads (at a pair of SM90_SPLIT_HEAD_DIMS), and q, k and v each aligned
    in its own layout (else made contiguous)."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"head dims {(q.shape[-1], v.shape[-1])}: the "
                        f"kernels take bfloat16 only, got {q.dtype}")
    if tables is not None:
        raise ValueError(f"head dims {(q.shape[-1], v.shape[-1])}: no fused "
                         "rope (rotate the roped dims before the call)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    return q, k, v, None


def check_group(q, k, v, window: int, causal: bool) -> None:
    """Raise for K/V heads or a window that attention over q, k, v does
    not take: K/V heads dividing the query heads, a window W >= 0 only on
    a causal call, and on a card fewer K/V heads or a window only at a
    pair of SM90_SPLIT_HEAD_DIMS (the plain versions take any head dims)."""
    heads, kv_heads = q.shape[2], k.shape[2]
    if kv_heads < 1 or heads % kv_heads or v.shape[2] != kv_heads:
        raise ValueError(f"K/V heads {k.shape[2]}, {v.shape[2]} do not "
                         f"divide {heads} query heads alike")
    if window < 0:
        raise ValueError(f"window {window}: a window is a positive key "
                         "count (0 for none)")
    if window and not causal:
        raise ValueError("a window needs causal attention")
    dims = (q.shape[-1], v.shape[-1])
    if q.device.type != "cpu" and (kv_heads != heads or window) \
            and dims not in SM90_SPLIT_HEAD_DIMS:
        raise ValueError(f"head dims {dims}: grouped K/V heads and a "
                         f"window run at {SM90_SPLIT_HEAD_DIMS} only")


def split_dkv(heads: int, kv_heads: int, window: int) -> bool:
    """Whether the fused Hopper backward splits a call: grouped K/V heads
    (heads != kv_heads) and no window. A split call runs one CTA per (K
    tile, query head), the MHA loop and launch order, and reduce-adds each
    CTA's fp32 dK and dV into a K/V head's accumulator, which a last
    launch rounds once; any other call sums a K/V tile's dK and dV in one
    CTA's registers (a window's band keeps its few Q tiles in L2 there).
    csrc/flash_bwd_sm90.cu's launch applies the same test."""
    return heads != kv_heads and not window


def bwd_workspace(q, k, v, window: int) -> int:
    """fp32 elements of the backward's one zero-filled workspace: dQ's
    accumulator [B, S, H, D], then for a split call (split_dkv) the K/V
    heads' dK and dV accumulator [B, S, Hkv, D + Dv]."""
    b, s, h, d = q.shape
    kv_heads = k.shape[2]
    extra = (b * s * kv_heads * (d + v.shape[-1])
             if split_dkv(h, kv_heads, window) else 0)
    return b * s * h * d + extra


def dkv_reduce_ctas(q, k, window: int) -> int:
    """CTAs of one backward call that reduce-add dK and dV: ceil(S / 128)
    K tiles x B x H for a split call, else 0 (the counter
    attention.dkv_reduce_ctas)."""
    b, s, h, _ = q.shape
    if not split_dkv(h, k.shape[2], window):
        return 0
    return -(-s // SM90_BWD_KEYS) * b * h


def _table_ptrs(tables):
    return (None, None) if tables is None else (tables[0].data_ptr(),
                                                tables[1].data_ptr())


def _dims(q, causal, tables, v=None, k=None, window=0):
    """The shape arguments every kernel takes after its pointers: k (by
    default q) gives Hkv and its own strides, v (by default q) Dv and its
    own strides."""
    v = q if v is None else v
    k = q if k is None else k
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, v.shape[-1], *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
            int(tables is not None), KERNEL_DTYPES[q.dtype])


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


def fwd(q, k, v, tables, *, causal: bool, window: int = 0):
    """(o [B, S, H, Dv], lse [B, H, S] fp32) of attention over q [B, S, H,
    D], k [B, S, Hkv, D] and v [B, S, Hkv, Dv]; tables = the [S, D] (cos,
    sinm) rope tables, or None for no rope; window W > 0 (causal only):
    query i sees keys (i - W, i]. Hkv < H and a window only where
    check_group allows."""
    check_group(q, k, v, window, causal)
    if _cuda.device_of(q, "flash") == "cpu":
        return fwd_plain(q, k, v, tables, causal=causal, window=window)
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
    _cuda.launch(kernel, q, *ptrs, *_dims(q, causal, tables, v, k, window))
    return o, lse


def _bwd_inputs(q, v, dout, lse, delta, dlse):
    b, s, h, _ = q.shape
    if dout.shape != (b, s, h, v.shape[-1]) or lse.shape != (b, h, s) \
            or delta.shape != (b, h, s) or dlse.shape != (b, h, s):
        raise ValueError("backward operands do not match q's [B, S, H, D]")
    dout = dout.to(q.dtype).contiguous()
    return (dout,) + tuple(x.float().contiguous() for x in (lse, delta, dlse))


def bwd(q, k, v, dout, lse, delta, dlse, tables, *, causal: bool,
        window: int = 0):
    """(dq [B, S, H, D], dk [B, S, Hkv, D], dv [B, S, Hkv, Dv]) of
    attention over q, k, v; dout [B, S, H, Dv]; lse, delta = rowsum(dO *
    O) and dlse (the lse cotangent) [B, H, S] fp32; tables and window as
    fwd's. On a card, under a profiler, counts attention.dkv_reduce_ctas
    (dkv_reduce_ctas: 0 but for a split call)."""
    check_group(q, k, v, window, causal)
    if _cuda.device_of(q, "flash") == "cpu":
        return bwd_plain(q, k, v, dout, lse, delta, dlse, tables,
                         causal=causal, window=window)
    q, k, v, tables = _kernel_inputs(q, k, v, tables)
    kernel = BWD_KERNELS[route(q.dtype, q.shape[-1], v.shape[-1])]
    dout, lse, delta, dlse = _bwd_inputs(q, v, dout, lse, delta, dlse)
    # dQ's fp32 accumulator, every K tile's CTA adds into it, and a split
    # call's dK and dV accumulator after it: one zero fill.
    dq_acc = torch.zeros(bwd_workspace(q, k, v, window), dtype=torch.float32,
                         device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _cuda.launch(kernel, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dlse.data_ptr(), *_table_ptrs(tables), dq_acc.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *_dims(q, causal, tables, v, k, window))
    trace.count("attention.dkv_reduce_ctas", dkv_reduce_ctas(q, k, window))
    return dq, dk, dv
