"""Flash attention (fwd + bwd) for Hopper — the model's hot op.

Counterpart of tpu_dra/workloads/flashattention.py. Tiled causal
attention: the [S, S] score matrix never reaches device memory, in
either direction. The forward streams K/V tiles for one Q tile through
shared memory with the online-softmax recurrence and saves the per-row
logsumexp; the backward recomputes probabilities tile by tile from
(q, k, lse) in one fused kernel per K/V tile (dK/dV in registers, dQ
added into an fp32 accumulator), for bf16 at D 64 and 128 (every model
path), at q.k 192 / v 128 (latent attention, mla.py: the caller ropes the
roped dims, so rope=False) and for the other inputs alike. The kernels are CUDA C++
(``csrc/``, launched by ``_flash_kernels``); this module holds
their contract: rope tables, the joint autograd over (out, lse), and the
``attend`` dispatch the model calls.

The reference has two tiers of kernels, resident and streaming, because
a TPU core's VMEM holds the stationary K/V and rope tables only up to a
budget (tpu_dra/workloads/flashattention.py:436-468). Each Hopper kernel
here keeps one stationary tile and streams the other side through
shared memory at every S, so its shared memory does not grow with S:
the forward a 128-row Q tile for bf16 at D 64 and 128 (flash_fwd_sm90,
every model path) and a 64-row one otherwise (flash_fwd: fp32, other
bf16 head dims), the fused backward a 128-key K/V tile (flash_bwd_sm90,
the same dtypes and head dims) and a 64-key one otherwise (flash_bwd_mma;
_flash_kernels.route picks for both directions).
So one kernel per direction and (dtype, D) serves both tiers: the port
has no ``_needs_streaming``, no ``STREAM_BLOCKS`` and no ``streaming=``
flag.

Grouped-query attention (k and v at fewer heads than q, a divisor) and a
causal sliding window (``window=W``: query i sees keys i - W < j <= i)
run on the (192, 128) Hopper instances (MiMo-V2-Flash, mimo_model.py):
the kernels read each K/V head where it is, and skip the key tiles
outside the band; K and V are never expanded to the query heads on the
card. The plain paths take them at any head dims.

Causal inputs of any length run on the kernels: they mask the ragged last
tile themselves (keys past S sit above every real row's diagonal, rows
past S are never stored), so nothing is padded here. Non-causal S must
be a whole number of kernel tiles (or fit in one), as the reference
refuses non-causal lengths its blocks do not divide.
"""

from __future__ import annotations

import functools
import math

import torch

from tpu_dra_torch.infra import trace
from tpu_dra_torch.infra.trace import device_span
from tpu_dra_torch.workloads import _flash_kernels
from tpu_dra_torch.workloads._flash_kernels import BLOCK
from tpu_dra_torch.workloads.ringattention import NEG_INF, reference_attention

__all__ = ["NEG_INF", "ROPE_BASE", "attend", "flash_attention",
           "flash_attention_with_lse", "rope_half"]

ROPE_BASE = 10000.0


def rope_half(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Half-split-pairing rotary embedding: plane j rotates dims
    (j, j+D/2) by positions * ROPE_BASE^(-2j/D). x: [B, S, H, D],
    positions: [B, S] (or broadcastable). fp32 math, x.dtype out.

    The plain counterpart of the in-kernel rotation, in the same roll
    form the tables use (``x * cos_t + roll(x, D/2) * sinm_t``) so every
    attention path computes the same function. Its trig is fp32 from the
    angles directly — not the kernels' tables, which are stored in the
    input dtype."""
    d = x.shape[-1]
    half = d // 2
    j = torch.arange(d, dtype=torch.float32, device=x.device) % half
    freqs = torch.exp(j * (-2.0 * math.log(ROPE_BASE) / d))
    angles = positions[..., None, None].to(torch.float32) * freqs
    cos_t = torch.cos(angles)
    # -sin pairs the first half with its +D/2 partner, +sin the second
    # half with its -D/2 partner (the roll).
    sign = torch.where(torch.arange(d, device=x.device) < half, -1.0, 1.0)
    sinm_t = torch.sin(angles) * sign
    xf = x.float()
    return (xf * cos_t + torch.roll(xf, half, dims=-1) * sinm_t).to(x.dtype)


def _rope_tables(s: int, d: int):
    """Full-width fp32 [S, D] tables: cos_t[p, j] = cos(theta(p, j mod
    D/2)); sinm_t carries the rotation's sign (-sin on the first half,
    +sin on the second), so roped = x * cos_t + roll(x, D/2) * sinm_t and
    the inverse rotation is the same expression with -sinm_t (applied by
    _flash_kernels.rope_rotate, the reference's _rope_apply)."""
    half = d // 2
    j = torch.arange(half, dtype=torch.float32)
    freqs = torch.exp(j * (-2.0 * math.log(ROPE_BASE) / d))
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=1), torch.cat([-sin, sin], dim=1)


@functools.lru_cache(maxsize=32)
def _rope_operands(s: int, d: int, dtype: torch.dtype, device: torch.device):
    """The tables as the kernels read them: stored in the input dtype for
    bf16 inputs (the rotation itself is fp32), as the TPU kernels store
    them; computed once on the host per (S, D, dtype, device) and never
    written to."""
    cos_t, sinm_t = _rope_tables(s, d)
    if dtype == torch.bfloat16:
        cos_t, sinm_t = cos_t.to(dtype), sinm_t.to(dtype)
    return cos_t.to(device), sinm_t.to(device)


class _FlashAttention(torch.autograd.Function):
    """[B, S, H, D] primitive returning (out, lse [B, H, S] fp32), both
    differentiable: an out-only consumer leaves dlse None (zeros) and the
    backward degenerates to plain flash; a consumer of lse (ring
    attention's merge) passes its cotangent through dS."""

    @staticmethod
    def forward(ctx, q, k, v, causal, rope, window):
        tables = (_rope_operands(q.shape[1], q.shape[-1], q.dtype, q.device)
                  if rope else None)
        out, lse = _flash_kernels.fwd(q, k, v, tables, causal=causal,
                                      window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.tables, ctx.window = causal, tables, window
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        with device_span("attention.bwd"):
            q, k, v, out, lse = ctx.saved_tensors
            if dout is None:
                dout = torch.zeros_like(out)
            dout = dout.to(q.dtype)
            dlse = torch.zeros_like(lse) if dlse is None else dlse.float()
            # delta_i = dO_i . O_i: one elementwise+reduce pass outside
            # the kernels, [B, H, S] like lse.
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            dq, dk, dv = _flash_kernels.bwd(q, k, v, dout, lse, delta, dlse,
                                            ctx.tables, causal=ctx.causal,
                                            window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             rope: bool = False, window: int = None):
    """q [B, S, H, D], k [B, S, Hkv, D], v [B, S, Hkv, Dv] -> (out [B, S,
    H, Dv], lse [B, H, S] fp32); Hkv = H but at the grouped pairs
    (_flash_kernels.check_group).

    Differentiable in BOTH outputs: lse is the per-row logsumexp of the
    scaled scores, which makes per-call results mergeable (ring
    attention) and gives a learned sink its weight (mimo_model.py).
    Causal S may be anything; non-causal S must be a multiple of the
    kernels' 64-row tile, or at most one tile.

    rope=True applies rope_half to q/k inside the kernels with positions
    = sequence index. window=W (causal): query i sees keys (i - W, i]."""
    s = q.shape[1]
    if not (causal or s <= BLOCK or s % BLOCK == 0):
        raise ValueError(f"seq len {s} not divisible by blocks "
                         f"({BLOCK}, {BLOCK}): non-causal S must be a "
                         "whole number of kernel tiles, as the reference "
                         "requires of its blocks")
    return _FlashAttention.apply(q, k, v, causal, rope, window or 0)


def flash_attention(q, k, v, *, causal: bool = True, rope: bool = False,
                    window: int = None):
    """q, k, v: [B, S, H, D] -> [B, S, H, D]; see flash_attention_with_lse."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal, rope=rope,
                                      window=window)
    return out


def _count_window(q, window: int) -> None:
    """Under a profiler, a window call's counters: the (query, key) pairs
    its band holds and the (Q tile, K tile) pairs the forward kernel
    visits, B x H of each."""
    if window and trace.recording():
        b, s, h = q.shape[:3]
        trace.count("attention.window_pairs",
                    b * h * _flash_kernels.band_pairs(s, window))
        trace.count("attention.window_tiles",
                    b * h * _flash_kernels.fwd_tiles(s, window))


def attend(q, k, v, *, causal: bool = True, impl: str = "auto",
           rope: bool = False, window: int = None, with_lse: bool = False):
    """Attention entrypoint for the workload models.

    impl: "auto" (the plain reference for CPU tensors, the flash path —
    the CUDA kernels — for any other), "flash" (the flash path on any
    device: the kernels on CUDA, their plain versions on the CPU — the
    port's counterpart of the reference's "flash_interpret"), "reference"
    (plain attention). On a CUDA tensor "auto" never reaches the plain
    reference: what the kernels refuse raises.

    rope=True fuses rope_half (positions = sequence index) into whichever
    path is chosen — in-kernel on the flash path, external on the
    reference path — so all impls compute the same function.

    k and v may hold fewer heads than q (a divisor: grouped-query
    attention), and window=W restricts a causal call to keys (i - W, i];
    on the flash path only where _flash_kernels.check_group allows.
    with_lse=True returns (out, lse [B, H, S] fp32), both differentiable.

    Under torch.profiler the call is the range ``attention.fwd``; a
    window call counts ``attention.window_pairs`` and
    ``attention.window_tiles``.
    """
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    with device_span("attention.fwd"):
        _count_window(q, window)
        if impl == "flash" or (impl == "auto" and q.device.type != "cpu"):
            out, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                                rope=rope, window=window)
            return (out, lse) if with_lse else out
        if rope:
            positions = torch.arange(q.shape[1], device=q.device)[None, :]
            q, k = rope_half(q, positions), rope_half(k, positions)
        return reference_attention(q, k, v, causal=causal, window=window,
                                   with_lse=with_lse)
