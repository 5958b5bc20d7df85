"""Plain float32 reference of the DeepSeek-V3-family LM train step
(Moonlight-16B-A3B's configuration), written from the papers' layer
equations (arXiv:2412.19437 §2.1 eq. 1-20; MLA from arXiv:2405.04434
§2.1) and the model's config.json, importing nothing of
``tpu_dra_torch``:

- token embedding (a gather), ``num_hidden_layers`` pre-norm blocks, a
  head RMSNorm with its learned scale, then the untied unembedding over
  the vocabulary slice;
- RMSNorm: x * rsqrt(mean(x^2) + rms_norm_eps) * scale;
- MLA: q = h W_q, per head [q_nope 128 | q_pe 64]; [c 512 | k_pe 64] =
  h W_kva, c = RMSNorm(c); [k_nope 128 | v 128] = c W_kvb per head; q_pe
  and the one k_pe rotated by position p (plane j rotates dims j and
  j + 32 by p * rope_theta^(-2j/64): half-split pairing, where
  DeepSeek's code pairs interleaved dims, a permutation of q_pe and k_pe
  alike that leaves every score as it is); k = [k_nope | k_pe]; causal
  softmax(q k^T / sqrt(192)) v; W_o;
- the first ``first_k_dense_replace`` blocks' FFN: (silu(h W_g) * h W_u)
  W_d; the others' MoE: s = sigmoid(h W_r) over the router's 64
  experts; the top 6 of s + b selected (b only selects); g_i = 2.446 *
  s_i / sum of the selected s; out = shared(h) + sum over the selected
  experts held here of g_i * E_i(h), E_i and the shared expert SwiGLU of
  1408 and 2 * 1408. Departure, as on the chip: only the held experts'
  terms (the other GPUs' experts are left out, in the program alike);
- loss: mean next-token cross-entropy plus aux_loss_alpha times, per MoE
  block, the sequence-wise balance loss sum_i f_i P_i (f_i = E/(k T) *
  #{t: i selected}, P_i = mean_t s_i / sum_j s_j), averaged over the
  batch's sequences;
- SGD: p <- p - lr * grad on every leaf (the bias gets no gradient).

Everything is float32 with TF32 off; each block and each block of query
rows of attention run under activation checkpointing, so B6 x S8192
fits. With precision "fp8" every product runs as
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

# Query rows per attention block: the [B, H, rows, S] scores of one
# block are what the reference holds at a time.
ATTN_ROWS = 512


def is_moe_block(cfg: Dict[str, Any], i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    """Every parameter: (path, shape, init), as the port's tree; weights
    N(0, 1/fan_in), embedding N(0, 0.02^2), norm scales 1, the selection
    bias N(0, bias_std^2). ``n_routed_experts`` experts are held."""
    v, d, h = cfg["vocab_size"], cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    r, f, e = (cfg["kv_lora_rank"], cfg["moe_intermediate_size"],
               cfg["n_routed_experts"])
    fs = f * cfg["n_shared_experts"]

    def w(*path, shape):
        return (path, shape, ("normal", 1 / math.sqrt(shape[-2])))

    out = [(("embed",), (v, d), ("normal", 0.02)), w("unembed", shape=(d, v)),
           (("final_norm",), (d,), ("ones",))]
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        out += [(b + ("ln1_scale",), (d,), ("ones",)),
                (b + ("ln2_scale",), (d,), ("ones",)),
                w(*b, "attn", "wq", shape=(d, h * (nope + rd))),
                w(*b, "attn", "wkv_a", shape=(d, r + rd)),
                (b + ("attn", "kv_norm"), (r,), ("ones",)),
                w(*b, "attn", "wkv_b", shape=(r, h * (nope + vd))),
                w(*b, "attn", "wo", shape=(h * vd, d))]
        if is_moe_block(cfg, i):
            m = b + ("moe",)
            out += [w(*m, "router", shape=(d, cfg["router_experts"])),
                    (m + ("bias",), (cfg["router_experts"],),
                     ("normal", cfg["bias_std"])),
                    w(*m, "w_gate", shape=(e, d, f)),
                    w(*m, "w_up", shape=(e, d, f)),
                    w(*m, "w_down", shape=(e, f, d)),
                    w(*m, "shared_gate", shape=(d, fs)),
                    w(*m, "shared_up", shape=(d, fs)),
                    w(*m, "shared_down", shape=(fs, d))]
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


def _attention_rows(q, k, v, start, mm):
    """Causal attention of query rows [start, start + rows) over keys
    [0, start + rows); q, k, v [B, H, *, d]."""
    rows, keys = q.shape[2], k.shape[2]
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    r = torch.arange(start, start + rows, device=q.device)[:, None]
    c = torch.arange(keys, device=q.device)[None, :]
    scores = scores.masked_fill(c > r, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def attention(q, k, v, mm):
    """q, k [B, S, H, 192], v [B, S, H, 128] -> [B, S, H, 128], causal,
    a block of ATTN_ROWS query rows at a time."""
    s = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    parts = []
    for start in range(0, s, ATTN_ROWS):
        end = min(s, start + ATTN_ROWS)
        parts.append(checkpoint(_attention_rows, qh[:, :, start:end],
                                kh[:, :, :end], vh[:, :, :end], start, mm,
                                use_reentrant=False))
    return torch.cat(parts, dim=2).transpose(1, 2)


def mla(cfg, p, h, mm):
    b, s, _ = h.shape
    heads = cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    q = mm(h, p["wq"]).view(b, s, heads, nope + rd)
    c, k_pe = mm(h, p["wkv_a"]).split([cfg["kv_lora_rank"], rd], -1)
    c = rmsnorm(c, p["kv_norm"], cfg["rms_norm_eps"])
    kv = mm(c, p["wkv_b"]).view(b, s, heads, nope + vd)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
    k_pe = rope(k_pe.view(b, s, 1, rd), theta).expand(b, s, heads, rd)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    o = attention(q, k, kv[..., nope:], mm)
    return mm(o.reshape(b, s, heads * vd), p["wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(cfg, p, h, mm):
    """(out, balance loss) of the MoE FFN on the normed h over the held
    experts [lo, lo + n_routed_experts)."""
    b, s, d = h.shape
    k, n_router = cfg["num_experts_per_tok"], cfg["router_experts"]
    scores = torch.sigmoid(mm(h, p["router"]))
    chosen = torch.topk(scores + p["bias"], k, dim=-1).indices
    picked = scores.gather(-1, chosen)
    gates = (cfg["routed_scaling_factor"] * picked
             / picked.sum(-1, keepdim=True)).reshape(-1, k)
    x = h.reshape(-1, d)
    out = swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"], mm)
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
    eps = cfg["rms_norm_eps"]
    x = x + mla(cfg, p["attn"], rmsnorm(x, p["ln1_scale"], eps), mm)
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
    x = rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"])
    return mm(x, params["unembed"]), aux_total


def loss(cfg: Dict[str, Any], params, tokens, precision: str = "fp32"):
    """Mean next-token cross-entropy of `tokens` [B, S] plus the weighted
    balance losses."""
    logits, aux_total = forward(cfg, params, tokens[:, :-1], precision)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.mean() + cfg["aux_loss_alpha"] * aux_total
