"""Kimi Delta Attention (KDA), the linear-attention layer of Kimi Linear
(arXiv:2510.26692; the public reference layer fla/layers/kda.py): a
gated delta rule with a per-channel decay.

On the normed residual h, for each of H heads of dk = dv wide:

- q, k, v = SiLU(causal depthwise conv(h W_q / W_k / W_v)), the conv
  4 taps wide over each channel's own past (no bias);
- q and k L2-normalised per head (eps ``l2_eps``), q scaled by
  1/sqrt(dk) (``_ShortConv``: conv, SiLU and norm in one pass);
- beta = sigmoid(h W_b), one value per head and token;
- the per-channel log-decay g = -exp(A_log_h) softplus(h W_f_a W_f_b +
  dt_bias), dk values per head and token (W_f a rank-``kda_rank``
  product; A_log_h = ``a_log_offset`` + the learned per-head
  ``a_log``);
- the recurrence S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} +
  beta_t k_t v_t^T from S_0 = 0, o_t = S_t^T q_t (``_KDAChunk``: the
  chunk kernels of _kda_kernels.py on a card, their plain chunk form on
  the CPU);
- y = RMSNorm_h(o) (a learned scale of dv, eps ``norm_eps``) *
  sigmoid(h W_g_a W_g_b + b_g) (``_GatedNorm``), then W_o.

Projections run in the config's dtype over fp32 masters ([in, out]
layout). The convs, norms and gates compute in fp32 and round once to
the config's dtype (_mixer_kernels.py: fused kernels on a card, their
plain versions on the CPU); g and beta are fp32. Each Function saves its
inputs alone and recomputes the rest in its backward. Under torch.profiler everything
between the input projections and W_o is the range ``attention.kda``,
and each call counts ``attention.kda_tokens`` (B x S) and
``attention.kda_chunks`` (B x H x ceil(S / 64)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_dra_torch.infra.trace import count, device_span, recording
from tpu_dra_torch.workloads import _kda_kernels, _mixer_kernels


class _KDAChunk(torch.autograd.Function):
    """o [B, S, H, dv] of the KDA recurrence; saves its inputs, and the
    backward recomputes the chunks' states from them."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta):
        ctx.save_for_backward(q, k, v, g, beta)
        return _kda_kernels.chunk_fwd(q, k, v, g, beta)

    @staticmethod
    def backward(ctx, do):
        return _kda_kernels.chunk_bwd(*ctx.saved_tensors, do)


class _ShortConv(torch.autograd.Function):
    """SiLU(causal depthwise conv of x [B, S, C] by w [taps, C]), L2-normed
    and scaled per head where `norm` (_mixer_kernels.short_conv)."""

    @staticmethod
    def forward(ctx, x, w, norm, scale, eps, head):
        ctx.save_for_backward(x, w)
        ctx.args = (norm, scale, eps, head)
        return _mixer_kernels.short_conv(x, w, norm, scale, eps, head)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dx, dw = _mixer_kernels.short_conv_bwd(x, w, dout, *ctx.args)
        return dx, dw.to(w.dtype), None, None, None, None


class _GatedNorm(torch.autograd.Function):
    """Each head's RMSNorm of o [B, S, C] times scale and sigmoid(gate +
    bias) (_mixer_kernels.gated_norm)."""

    @staticmethod
    def forward(ctx, o, gate, bias, scale, eps):
        ctx.save_for_backward(o, gate, bias, scale)
        ctx.eps = eps
        return _mixer_kernels.gated_norm(o, gate, bias, scale, eps)

    @staticmethod
    def backward(ctx, dout):
        o, gate, bias, scale = ctx.saved_tensors
        do, dgate, dbias, dscale = _mixer_kernels.gated_norm_bwd(
            o, gate, bias, scale, dout, ctx.eps)
        return do, dgate, dbias.to(bias.dtype), dscale.to(scale.dtype), None


class _Decay(torch.autograd.Function):
    """The fp32 log-decay -exp(offset + a_log_h) softplus(f + dt_bias)
    [B, S, H, dk] of f [B, S, H dk] (plain PyTorch)."""

    @staticmethod
    def forward(ctx, f, a_log, dt_bias, offset):
        ctx.save_for_backward(f, a_log, dt_bias)
        ctx.offset = offset
        b, s, _ = f.shape
        x = (f.float() + dt_bias).view(b, s, a_log.shape[0], -1)
        return -torch.exp(offset + a_log)[:, None] * F.softplus(x)

    @staticmethod
    def backward(ctx, dg):
        f, a_log, dt_bias = ctx.saved_tensors
        b, s, _ = f.shape
        x = (f.float() + dt_bias).view(dg.shape)
        a = -torch.exp(ctx.offset + a_log)[:, None]
        dx = dg * a * torch.sigmoid(x)
        da = (dg * a * F.softplus(x)).sum((0, 1, 3))
        dx = dx.reshape(b, s, -1)
        return dx.to(f.dtype), da, dx.sum((0, 1)), None


def kda(cfg, p, h: torch.Tensor) -> torch.Tensor:
    """y W_o [B, S, D] of the normed h [B, S, D]; `p` holds wq, wk, wv [D,
    H dk], q_conv, k_conv, v_conv [taps, H dk], wf_a [D, rank], wf_b
    [rank, H dk], a_log [H], dt_bias [H dk], wb [D, H], wg_a [D, rank],
    wg_b [rank, H dv], g_bias [H dv], o_norm [dv] and wo [H dv, D] (fp32
    masters)."""
    cd = cfg.dtype
    b, s, _ = h.shape
    heads, dk = cfg.kda_heads, cfg.kda_head_dim
    q, k, v = (h @ p[name].to(cd) for name in ("wq", "wk", "wv"))
    f = (h @ p["wf_a"].to(cd)) @ p["wf_b"].to(cd)
    gate = (h @ p["wg_a"].to(cd)) @ p["wg_b"].to(cd)
    b_raw = h @ p["wb"].to(cd)
    with device_span("attention.kda"):
        if recording():
            count("attention.kda_tokens", b * s)
            count("attention.kda_chunks",
                  b * heads * _kda_kernels.n_chunks(s))
        q = _ShortConv.apply(q, p["q_conv"], True, 1.0 / math.sqrt(dk),
                             cfg.l2_eps, dk)
        k = _ShortConv.apply(k, p["k_conv"], True, 1.0, cfg.l2_eps, dk)
        v = _ShortConv.apply(v, p["v_conv"], False, 1.0, cfg.l2_eps, dk)
        g = _Decay.apply(f, p["a_log"], p["dt_bias"], cfg.a_log_offset)
        beta = torch.sigmoid(b_raw.float())
        o = _KDAChunk.apply(*(x.view(b, s, heads, -1) for x in (q, k, v)),
                            g, beta)
        o = _GatedNorm.apply(o.view(b, s, -1), gate, p["g_bias"],
                             p["o_norm"], cfg.norm_eps)
    return o @ p["wo"].to(cd)
