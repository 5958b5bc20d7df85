"""Plain float32 reference of the MiMo-V2-Flash-family LM train step,
written from the model's config.json (``mimo_v2_flash``) and its
published description (hybrid attention, 5 sliding-window layers with a
learnable attention sink to 1 global, grouped-query attention, a sigmoid
top-8 MoE), importing nothing of ``tpu_dra_torch``:

- token embedding (a gather), ``num_hidden_layers`` pre-norm blocks, a
  head RMSNorm with its learned scale, then the untied unembedding over
  the vocabulary slice;
- RMSNorm: x * rsqrt(mean(x^2) + layernorm_epsilon) * scale;
- attention, per layer, window or global by ``hybrid_layer_pattern``
  (1 window, 0 global): q = h W_q (num_attention_heads heads of
  head_dim), k = h W_k and v = h W_v (num_key_value_heads heads in a
  global layer, swa_num_key_value_heads in a window layer; of head_dim
  and v_head_dim), query head h reading K/V head h // (heads per K/V
  head); the first int(partial_rotary_factor * head_dim) dims of q and k
  rotated by position p (plane j rotates dims j and j + R/2 by
  p * theta^(-2j/R), theta = rope_theta or swa_rope_theta); scores
  q k^T / sqrt(head_dim), causal, a window layer's restricted by an
  explicit mask to the last sliding_window keys (i - W < j <= i); a
  window layer's softmax runs over the row's scores and one more column,
  the head's sink logit (sink_offset + the learned sink), whose column
  is then dropped; o scaled by attention_value_scale (which scales v; o
  is linear in v), then W_o;
- the FFN of the blocks whose moe_layer_freq is 0: (silu(h W_g) * h W_u)
  W_d; the others' MoE: s = sigmoid(h W_r) over the router's experts;
  the top num_experts_per_tok of s + b selected (b only selects); g_i =
  s_i / sum of the selected s (norm_topk_prob, no routed scaling); out =
  sum over the selected experts held here of g_i * E_i(h), E_i SwiGLU of
  moe_intermediate_size, no shared expert. Departure, as on the chip:
  only the held experts' terms (the other GPUs' experts are left out,
  in the program alike);
- loss: mean next-token cross-entropy plus aux_loss_alpha times, per MoE
  block, the sequence-wise balance loss sum_i f_i P_i (f_i = E/(k T) *
  #{t: i selected}, P_i = mean_t s_i / sum_j s_j), averaged over the
  batch's sequences;
- SGD: p <- p - lr * grad on every leaf (the bias gets no gradient).

Everything is float32 with TF32 off; each block and each block of query
rows of attention run under activation checkpointing, so B1 x S32768
fits: a block of rows sees only the keys it may (the window's start to
the block's last row). With precision "fp8" every product runs as
``precision.fp8_matmul`` (the control).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference import precision as prec

# Query rows per attention block of a global layer: the [B, H, rows, S]
# scores of one block are what the reference holds at a time.
ATTN_ROWS = 256
# ... and of a window layer, whose rows see at most sliding_window keys.
WINDOW_ROWS = 2048


def is_moe_block(cfg: Dict[str, Any], i: int) -> bool:
    return bool(cfg["moe_layer_freq"][i])


def is_window_block(cfg: Dict[str, Any], i: int) -> bool:
    return bool(cfg["hybrid_layer_pattern"][i])


def kv_heads(cfg: Dict[str, Any], i: int) -> int:
    return cfg["swa_num_key_value_heads" if is_window_block(cfg, i)
               else "num_key_value_heads"]


def rope_dims(cfg: Dict[str, Any]) -> int:
    return int(cfg["partial_rotary_factor"] * cfg["head_dim"])


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    """Every parameter: (path, shape, init), as the port's tree; weights
    N(0, 1/fan_in), embedding N(0, 0.02^2), norm scales 1, the selection
    bias N(0, bias_std^2), each window layer's sinks N(0, 1) (the sink
    logit adds sink_offset). ``n_routed_experts`` experts are held."""
    v, d, h = cfg["vocab_size"], cfg["hidden_size"], cfg["num_attention_heads"]
    dqk, dv = cfg["head_dim"], cfg["v_head_dim"]
    f, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]

    def w(*path, shape):
        return (path, shape, ("normal", 1 / math.sqrt(shape[-2])))

    out = [(("embed",), (v, d), ("normal", 0.02)), w("unembed", shape=(d, v)),
           (("final_norm",), (d,), ("ones",))]
    for i in range(cfg["num_hidden_layers"]):
        b, hkv = ("blocks", i), kv_heads(cfg, i)
        out += [(b + ("ln1_scale",), (d,), ("ones",)),
                (b + ("ln2_scale",), (d,), ("ones",)),
                w(*b, "attn", "wq", shape=(d, h * dqk)),
                w(*b, "attn", "wk", shape=(d, hkv * dqk)),
                w(*b, "attn", "wv", shape=(d, hkv * dv)),
                w(*b, "attn", "wo", shape=(h * dv, d))]
        if is_window_block(cfg, i):
            out.append((b + ("attn", "sinks"), (h,), ("normal", 1.0)))
        if is_moe_block(cfg, i):
            m = b + ("moe",)
            out += [w(*m, "router", shape=(d, cfg["router_experts"])),
                    (m + ("bias",), (cfg["router_experts"],),
                     ("normal", cfg["bias_std"])),
                    w(*m, "w_gate", shape=(e, d, f)),
                    w(*m, "w_up", shape=(e, d, f)),
                    w(*m, "w_down", shape=(e, f, d))]
        else:
            fd = b + ("ffn",)
            out += [w(*fd, "w_gate", shape=(d, cfg["intermediate_size"])),
                    w(*fd, "w_up", shape=(d, cfg["intermediate_size"])),
                    w(*fd, "w_down", shape=(cfg["intermediate_size"], d))]
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x [B, S, H, R]: plane j rotates (x_j, x_{j + R/2}) by p theta_j."""
    s, r = x.shape[1], x.shape[-1]
    j = torch.arange(r // 2, dtype=torch.float64, device=x.device)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * theta ** (-2.0 * j / r))
    cos, sin = (t.float()[None, :, None, :] for t in (ang.cos(), ang.sin()))
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention_rows(q, k, v, sink, start, lo, window, mm):
    """Query rows [start, start + rows) of every head over keys [lo,
    start + rows): q [B, Hkv, G, rows, D], k [B, Hkv, keys, D], v [B, Hkv,
    keys, Dv]; the window's and the causal mask explicit; with a sink
    [Hkv, G, 1], its logit as one more column of the softmax, dropped
    after. -> [B, Hkv, G, rows, Dv]."""
    b, hkv, g, rows, d = q.shape
    keys = k.shape[2]
    scores = mm(q.reshape(b, hkv, g * rows, d), k.transpose(-1, -2))
    scores = scores.view(b, hkv, g, rows, keys) * (1.0 / math.sqrt(d))
    i = torch.arange(start, start + rows, device=q.device)[:, None]
    j = torch.arange(lo, lo + keys, device=q.device)[None, :]
    keep = j <= i
    if window:
        keep = keep & (i - j < window)
    scores = scores.masked_fill(~keep, float("-inf"))
    if sink is not None:
        col = sink[None, :, :, :, None].expand(b, hkv, g, rows, 1)
        p = torch.softmax(torch.cat([scores, col], -1), dim=-1)[..., :keys]
    else:
        p = torch.softmax(scores, dim=-1)
    out = mm(p.reshape(b, hkv, g * rows, keys), v)
    return out.view(b, hkv, g, rows, v.shape[-1])


def attention(q, k, v, window, sink, mm):
    """q [B, S, H, D], k [B, S, Hkv, D], v [B, S, Hkv, Dv] -> [B, S, H,
    Dv]: causal (window > 0: over the last `window` keys), a block of
    query rows at a time over the keys it may see; sink [H] or None."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qh = q.view(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    sk = None if sink is None else sink.view(hkv, g, 1)
    rows = WINDOW_ROWS if window else ATTN_ROWS
    parts = []
    for start in range(0, s, rows):
        end = min(s, start + rows)
        lo = max(0, start - window + 1) if window else 0
        parts.append(checkpoint(_attention_rows, qh[:, :, :, start:end],
                                kh[:, :, lo:end], vh[:, :, lo:end], sk,
                                start, lo, window, mm, use_reentrant=False))
    o = torch.cat(parts, dim=3)                       # [B, Hkv, G, S, Dv]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, -1)


def hybrid_attention(cfg, i, p, h, mm):
    b, s, _ = h.shape
    heads, dqk, dv = (cfg["num_attention_heads"], cfg["head_dim"],
                      cfg["v_head_dim"])
    window = cfg["sliding_window"] if is_window_block(cfg, i) else 0
    q = mm(h, p["wq"]).view(b, s, heads, dqk)
    k = mm(h, p["wk"]).view(b, s, -1, dqk)
    v = mm(h, p["wv"]).view(b, s, -1, dv)
    r = rope_dims(cfg)
    theta = cfg["swa_rope_theta"] if window else cfg["rope_theta"]
    q = torch.cat([rope(q[..., :r], theta), q[..., r:]], -1)
    k = torch.cat([rope(k[..., :r], theta), k[..., r:]], -1)
    sink = cfg["sink_offset"] + p["sinks"] if window else None
    o = attention(q, k, v, window, sink, mm) * cfg["attention_value_scale"]
    return mm(o.reshape(b, s, heads * dv), p["wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(cfg, p, h, mm):
    """(out, balance loss) of the MoE FFN on the normed h over the held
    experts [lo, lo + n_routed_experts); no shared expert."""
    b, s, d = h.shape
    k, n_router = cfg["num_experts_per_tok"], cfg["router_experts"]
    scores = torch.sigmoid(mm(h, p["router"]))
    chosen = torch.topk(scores + p["bias"], k, dim=-1).indices
    picked = scores.gather(-1, chosen)
    gates = (picked / picked.sum(-1, keepdim=True)).reshape(-1, k)
    x = h.reshape(-1, d)
    out = torch.zeros_like(x)
    lo = cfg["experts_held"][0]
    flat = chosen.reshape(-1, k)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(flat == lo + j, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                       mm)
            out = out.index_add(0, tok, gates[tok, slot, None] * y)
    with torch.no_grad():
        share = torch.zeros(b, n_router, device=h.device).scatter_add_(
            1, chosen.reshape(b, -1), torch.ones(b, s * k, device=h.device))
        share = share * (n_router / (k * s))
    prob = (scores / scores.sum(-1, keepdim=True)).mean(1)
    return out.view(b, s, d), (share * prob).sum(-1).mean()


def block(cfg, i, p, x, mm):
    """One block: (x, its balance loss; 0 for a dense block)."""
    eps = cfg["layernorm_epsilon"]
    x = x + hybrid_attention(cfg, i, p["attn"],
                             rmsnorm(x, p["ln1_scale"], eps), mm)
    h = rmsnorm(x, p["ln2_scale"], eps)
    if is_moe_block(cfg, i):
        out, aux = moe(cfg, p["moe"], h, mm)
        return x + out, aux
    f = p["ffn"]
    return (x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], mm),
            torch.zeros((), device=x.device))


def forward(cfg: Dict[str, Any], params, inputs, precision: str = "fp32"):
    """(logits [B, S, V], the summed balance losses) of input ids
    `inputs` [B, S]."""
    mm = prec.matmul(precision)
    x = params["embed"][inputs]
    aux_total = torch.zeros((), device=x.device)
    for i, p in enumerate(params["blocks"]):
        x, aux = checkpoint(block, cfg, i, p, x, mm, use_reentrant=False)
        aux_total = aux_total + aux
    x = rmsnorm(x, params["final_norm"], cfg["layernorm_epsilon"])
    return mm(x, params["unembed"]), aux_total


def loss(cfg: Dict[str, Any], params, tokens, precision: str = "fp32"):
    """Mean next-token cross-entropy of `tokens` [B, S] plus the weighted
    balance losses."""
    logits, aux_total = forward(cfg, params, tokens[:, :-1], precision)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.mean() + cfg["aux_loss_alpha"] * aux_total
