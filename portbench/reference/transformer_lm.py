"""Plain float32 reference of the dense TransformerLM train step.

Written from the model's description, not from the port's code, and
importing nothing of ``tpu_dra_torch``:

- token embedding (a gather), then ``n_layers`` pre-norm blocks and an
  RMS-normed head (no scale) projecting to the vocabulary;
- RMSNorm: x * rsqrt(mean(x^2) + 1e-6) * scale;
- attention: a fused [D, 3D] projection split q | k | v, heads of
  D / n_heads; rotary embedding on q and k with half-split pairing
  (plane j rotates dims j and j + d/2 by position * 10000^(-2j/d)); causal
  softmax(q k^T / sqrt(d)) v; output projection; residual;
- FFN: tanh-GELU(h W_up) W_down; residual;
- loss: mean next-token cross-entropy over B x (S - 1) positions;
- SGD: p <- p - lr * grad on every parameter.

Everything is float32, with TF32 off; attention runs a block of query
rows at a time under activation checkpointing, so S = 16384 fits. With
precision "fp8" every product runs as ``precision.fp8_matmul`` (the
control).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference import precision as prec

ROPE_BASE = 10000.0
EPS = 1e-6
# Query rows per attention block (the [rows, S] scores of one block are
# what the reference holds at a time).
ATTN_ROWS = 1024


def block_leaves(cfg: Dict[str, Any], i: int) -> List[weights.Leaf]:
    d, f = cfg["d_model"], cfg["d_ff"]
    return [
        (("blocks", i, "ln1_scale"), (d,), ("ones",)),
        (("blocks", i, "ln2_scale"), (d,), ("ones",)),
        (("blocks", i, "wqkv"), (d, 3 * d), ("normal", 1 / math.sqrt(d))),
        (("blocks", i, "wo"), (d, d), ("normal", 1 / math.sqrt(d))),
        (("blocks", i, "w_up"), (d, f), ("normal", 1 / math.sqrt(d))),
        (("blocks", i, "w_down"), (f, d), ("normal", 1 / math.sqrt(f))),
    ]


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    """Every parameter: (path in the tree, shape, init). Scales as the
    model's own init: embedding N(0, 0.02^2), weights N(0, 1/fan_in)."""
    v, d = cfg["vocab"], cfg["d_model"]
    out = [(("embed",), (v, d), ("normal", 0.02)),
           (("unembed",), (d, v), ("normal", 1 / math.sqrt(d)))]
    for i in range(cfg["n_layers"]):
        out += block_leaves(cfg, i)
    return out


def rmsnorm(x, scale=None):
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS)
    return y if scale is None else y * scale


def rope(x):
    """x [B, S, H, d]: plane j rotates (x_j, x_{j+d/2}) by pos * theta_j."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    theta = ROPE_BASE ** (-2.0 * torch.arange(half, dtype=torch.float64,
                                              device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * theta
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention_rows(q, k, v, start, mm):
    """Causal attention of query rows [start, start + rows) over keys
    [0, start + rows); [B, H, rows, d]."""
    rows, keys = q.shape[2], k.shape[2]
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    r = torch.arange(start, start + rows, device=q.device)[:, None]
    c = torch.arange(keys, device=q.device)[None, :]
    scores = scores.masked_fill(c > r, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def attention(q, k, v, mm):
    """q, k, v [B, S, H, d] (roped) -> [B, S, H, d], causal."""
    s = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if s <= ATTN_ROWS:
        return _attention_rows(qh, kh, vh, 0, mm).transpose(1, 2)
    parts = []
    for start in range(0, s, ATTN_ROWS):
        end = min(s, start + ATTN_ROWS)
        parts.append(checkpoint(_attention_rows, qh[:, :, start:end],
                                kh[:, :, :end], vh[:, :, :end], start, mm,
                                use_reentrant=False))
    return torch.cat(parts, dim=2).transpose(1, 2)


def attention_sublayer(cfg, p, x, mm):
    b, s, d = x.shape
    heads = cfg["n_heads"]
    qkv = mm(rmsnorm(x, p["ln1_scale"]), p["wqkv"])
    q, k, v = (t.reshape(b, s, heads, d // heads) for t in qkv.split(d, -1))
    ctx = attention(rope(q), rope(k), v, mm)
    return x + mm(ctx.reshape(b, s, d), p["wo"])


def ffn(p, x, mm):
    h = rmsnorm(x, p["ln2_scale"])
    return x + mm(F.gelu(mm(h, p["w_up"]), approximate="tanh"), p["w_down"])


def head_nll(params, x, targets, mm):
    """Per-position cross-entropy of the next token, [B, S]."""
    logits = mm(rmsnorm(x), params["unembed"])
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, targets[..., None])[..., 0]


def nll(cfg, params, tokens, mm):
    x = params["embed"][tokens[:, :-1]]
    for p in params["blocks"]:
        x = ffn(p, attention_sublayer(cfg, p, x, mm), mm)
    return head_nll(params, x, tokens[:, 1:], mm)


def loss(cfg: Dict[str, Any], params, tokens, precision: str = "fp32"):
    """Mean next-token cross-entropy of `tokens` [B, S]."""
    return nll(cfg, params, tokens, prec.matmul(precision)).mean()
