"""Ring attention: sequence-parallel causal attention around a ring of
ranks (counterpart of tpu_dra/workloads/ringattention.py).

The sequence is sharded over a mesh axis; each rank holds one Q/K/V
block and the K/V blocks rotate around the ring (``_dist.rotate`` of the
stacked pair, one send and one receive per step), so every rank sees every
block after axis-size steps. Each step computes a PARTIAL softmax
attention of the local Q against the visiting block, and partials merge
by their logsumexp, so no rank ever forms the [S, S] score matrix.

Each step's partial is ``flash_attention_with_lse(..., rope=False)``
(the CUDA kernels on a card; their plain versions on the CPU), or the
plain ``_torch_partial`` with ``impl="reference"``. Its lse is
differentiable, so the backward runs the kernels with the merge's lse
cotangent (nonzero dlse) and, on the past blocks, in non-causal mode.
RoPE stays outside the ring, as in the reference: a rank's partials see
keys at positions its own block's rope tables do not cover.

``ring_attention_local`` runs an N-rank ring in one process, each rank's
steps in turn through the same per-step partial and merge, for checking
a ring's arithmetic at a real shape on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_dra_torch.workloads import _dist, _flash_kernels

NEG_INF = -1e30
# Each step's case, by where the visiting block sits against the local
# one: entirely in the future, on the diagonal, entirely in the past.
FUTURE, DIAGONAL, PAST = 0, 1, 2


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        with_lse: bool = False):
    """Unsharded attention, q [B, S, H, D], k [B, S, Hkv, D], v [B, S, Hkv,
    Dv] (Hkv a divisor of H: query head h reads K/V head h // (H / Hkv)).
    Scores are formed and scaled in the input dtype, then softmaxed in
    fp32, as the JAX reference does. window=W (causal): query i sees keys
    (i - W, i]. with_lse=True returns (out, lse [B, H, S] fp32), the rows'
    logsumexp of the scaled scores."""
    h, s, d = q.shape[2], q.shape[1], q.shape[-1]
    k, v = (_flash_kernels.expand_heads(x, h) for x in (k, v))
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)).float()
    if causal:
        keep = _flash_kernels.band_mask(s, window or 0, q.device)
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if with_lse else out


def _torch_partial(q, k, v, causal):
    """(out [B, Sq, H, D], lse [B, H, Sq]) of q against one K/V block,
    plain PyTorch (the reference's _jnp_partial). lse is over scaled
    scores — flash_attention_with_lse's convention, so partials merge
    either way."""
    d = q.shape[-1]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)).float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = scores.masked_fill(~keep, NEG_INF)
    block_max = scores.amax(-1)
    p = torch.exp(scores - block_max[..., None])
    denom = p.sum(-1)
    lse = block_max + torch.log(denom.clamp_min(1e-30))
    out = torch.einsum("bhqk,bkhd->bqhd", (p / denom[..., None]).to(v.dtype),
                       v).to(q.dtype)
    return out, lse


def ring_flash_ok(s_local: int, d: int) -> bool:
    """Flash per-step partials need a tile size dividing s_local (the
    past-block case is non-causal, which cannot be padded): the
    reference's refusal, stricter than the kernels' own 64."""
    return s_local % 128 == 0 and d >= 8


def _use_flash(impl: str, q: torch.Tensor) -> bool:
    _, s_local, _, d = q.shape
    if impl == "auto":
        # The kernels on a card, the plain partials on the CPU. Unlike the
        # reference's "auto", a shape the flash ring refuses raises on a
        # card rather than running the plain partials there (attend's
        # contract).
        impl = "flash" if q.device.type == "cuda" else "reference"
    if impl == "flash":
        if not ring_flash_ok(s_local, d):
            raise ValueError(
                "flash ring needs s_local % 128 == 0 and head dim >= 8 "
                f"(got s_local={s_local}, d={d})")
        return True
    if impl == "reference":
        return False
    raise ValueError(f"unknown ring attention impl {impl!r}")


def step_case(my_index: int, kv_index: int, causal: bool) -> int:
    if not causal:
        return PAST
    if kv_index > my_index:
        return FUTURE
    return DIAGONAL if kv_index == my_index else PAST


class _FutureBlock(torch.autograd.Function):
    """A future block's partial, (0, NEG_INF), the identity of the merge,
    kept on the autograd graph: its backward hands the visiting block a
    zero gradient, so every rank's backward runs every rotation's
    backward, in the one order the chain of rotations fixes (a rank that
    skipped one, as autograd skips what the loss does not reach, would
    leave its neighbours waiting)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.kv = [(x.shape, x.dtype, x.device) for x in (k, v)]
        b, s, h, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, dout, dlse):
        return (None, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.kv))


def step_partial(q, k_blk, v_blk, case: int, use_flash: bool):
    """One ring step's (out, lse): _FutureBlock's (0, NEG_INF) for a
    future block; causal attention on the diagonal; non-causal on a past
    block."""
    if case == FUTURE:
        return _FutureBlock.apply(q, k_blk, v_blk)
    causal = case == DIAGONAL
    if use_flash:
        from tpu_dra_torch.workloads.flashattention import (
            flash_attention_with_lse,
        )

        return flash_attention_with_lse(q, k_blk, v_blk, causal=causal,
                                        rope=False)
    return _torch_partial(q, k_blk, v_blk, causal)


def merge(acc_o, acc_lse, o_b, lse_b):
    """Partials merged by logsumexp weight, in fp32:
        new_lse = logaddexp(acc_lse, lse_b)
        acc_o   = acc_o * e^(acc_lse - new_lse) + o_b * e^(lse_b - new_lse)
    NEG_INF is a FINITE sentinel (-1e30): (-1e30) - (-1e30) stays 0, so
    merges before the first contribution are NaN-free."""
    new_lse = torch.logaddexp(acc_lse, lse_b)
    w_old = torch.exp(acc_lse - new_lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_b - new_lse).transpose(1, 2)[..., None]
    return acc_o * w_old + o_b.float() * w_new, new_lse


def _start(q):
    b, s, h, d = q.shape
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                       device=q.device))


def ring_attention(q, k, v, *, group, causal: bool = True,
                   impl: str = "auto"):
    """This rank's body: q, k, v are its LOCAL sequence blocks
    [B, S_local, H, D] (block i of the sequence on the group's rank i).
    K/V rotate ring-wise (rank p sends to p - 1, so step i sees the block
    of rank p + i); returns the local block of the attention output.

    impl: "auto" (the flash partials on a CUDA tensor, the plain ones on
    a CPU tensor), "flash" (the flash partials on any device; refuses
    the shapes ring_flash_ok refuses), "reference" (plain)."""
    use_flash = _use_flash(impl, q)
    n, me = _dist.group_size(group), _dist.group_rank(group)
    acc_o, acc_lse = _start(q)
    # K and V travel together: one rotation per step, a chain whose
    # backward runs in the same order on every rank.
    kv = torch.stack((k, v))
    for i in range(n):
        case = step_case(me, (me + i) % n, causal)
        o_b, lse_b = step_partial(q, kv[0], kv[1], case, use_flash)
        acc_o, acc_lse = merge(acc_o, acc_lse, o_b, lse_b)
        if i + 1 < n:   # the reference's last rotation is redundant
            kv = _dist.rotate(kv, group, -1)
    return acc_o.to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "data", causal: bool = True,
                        impl: str = "auto"):
    """Sequence-parallel attention over `mesh`'s `axis_name` axis:
    fn(q, k, v) on this rank's sequence blocks [B, S/N, H, D] returns its
    block of the output (the reference's inputs and outputs sharded on
    S)."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, causal=causal, impl=impl)

    return fn


def ring_attention_local(q, k, v, n: int, *, causal: bool = True,
                         impl: str = "auto", partial_counts: Optional[dict]
                         = None):
    """An n-rank ring in one process: q, k, v the whole [B, S, H, D]
    sequence; rank r's steps run in turn through step_partial and merge
    on the blocks rank r would see, and the blocks' outputs concatenate.
    Differentiable, as the distributed ring. `partial_counts`, when
    given, counts the steps by case."""
    qs, ks, vs = (x.chunk(n, dim=1) for x in (q, k, v))
    use_flash = _use_flash(impl, qs[0])
    outs = []
    for r in range(n):
        acc_o, acc_lse = _start(qs[r])
        for i in range(n):
            kv = (r + i) % n
            case = step_case(r, kv, causal)
            if partial_counts is not None:
                partial_counts[case] = partial_counts.get(case, 0) + 1
            o_b, lse_b = step_partial(qs[r], ks[kv], vs[kv], case, use_flash)
            acc_o, acc_lse = merge(acc_o, acc_lse, o_b, lse_b)
        outs.append(acc_o.to(q.dtype))
    return torch.cat(outs, dim=1)
