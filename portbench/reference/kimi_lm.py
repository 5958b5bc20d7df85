"""Plain float32 reference of the Kimi Linear-family LM train step
(Kimi-Linear-48B-A3B's configuration), written from the model's
config.json (``kimi_linear``), the Kimi Linear technical report
(arXiv:2510.26692: Kimi Delta Attention, 3 KDA layers to 1 MLA layer)
and the public reference layer (fla/layers/kda.py in
flash-linear-attention), importing nothing of ``tpu_dra_torch``:

- token embedding (a gather), ``num_hidden_layers`` pre-norm blocks, a
  head RMSNorm with its learned scale, then the untied unembedding over
  the vocabulary slice;
- RMSNorm: x * rsqrt(mean(x^2) + rms_norm_eps) * scale;
- the token mixer of layer i (1-based i + 1 in
  ``linear_attn_config.kda_layers``: KDA, else MLA):
  - KDA, per head of linear_attn_config.head_dim (dk = dv = 128):
    q, k, v = SiLU(causal depthwise conv over short_conv_kernel_size
    taps of h W_q, h W_k, h W_v, no bias); q, k L2-normalised per head
    (x / sqrt(sum x^2 + kda_l2_eps)), q times 1/sqrt(dk); beta =
    sigmoid(h W_b); g = -exp(A_log) softplus(h W_f_a W_f_b + dt_bias),
    W_f of rank head_dim; S_t = (I - beta_t k_t k_t^T) Diag(exp g_t)
    S_{t-1} + beta_t k_t v_t^T, S_0 = 0, o_t = S_t^T q_t
    (``kda_recurrent`` token by token, ``kda_chunked`` in 64-token
    chunks); y = RMSNorm_h(o) * o_norm * sigmoid(h W_g_a W_g_b + b_g);
    y W_o;
  - MLA with NoPE (mla_use_nope): q = h W_q, per head [q_nope 128 |
    q_pe 64]; [c 512 | k_pe 64] = h W_kva, c = RMSNorm(c); [k_nope 128 |
    v 128] = c W_kvb per head; k = [k_nope | k_pe], nothing rotated;
    causal softmax(q k^T / sqrt(192)) v, a block of query rows at a time;
    W_o;
- the first ``first_k_dense_replace`` blocks' FFN: (silu(h W_g) * h W_u)
  W_d; the others' MoE: s = sigmoid(h W_r) over the router's 256
  experts; the top 8 of s + b selected (b only selects); g_i = 2.446 *
  s_i / sum of the selected s; out = shared(h) + sum over the selected
  experts held here of g_i * E_i(h), E_i and the one shared expert
  SwiGLU of 1024;
- loss: mean next-token cross-entropy plus aux_loss_alpha times, per MoE
  block, the sequence-wise balance loss sum_i f_i P_i (f_i = E/(k T) *
  #{t: i selected}, P_i = mean_t s_i / sum_j s_j), averaged over the
  batch's sequences;
- SGD: p <- p - lr * grad on every leaf (the bias gets no gradient).

Departures from the published description:

- only the held experts' terms (the other GPUs' experts are left out,
  in the program alike);
- A_log is a_log_offset plus a learned per-head parameter drawn N(0,
  a_log_std^2) (the benchmark draws normals; fla draws A_log as log U(1,
  16), which ln 4 +- 2 x 0.69 spans), dt_bias and b_g start at 0;
- the selection bias is fixed (its update belongs to the training
  loop).

Everything is float32 with TF32 off; each block, each 64-token chunk of
a KDA layer and each block of query rows of attention run under
activation checkpointing, so B1 x S32768 fits. With precision "fp8"
every product (projections, the chunk form's state products, attention)
runs as ``precision.fp8_matmul`` (the control).
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
ATTN_ROWS = 256
# Rows of a KDA chunk.
CHUNK = 64


def is_moe_block(cfg: Dict[str, Any], i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def is_kda_block(cfg: Dict[str, Any], i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def kda_dims(cfg: Dict[str, Any]):
    """(heads, head dim, conv taps) of the KDA layers; the low rank of
    W_f and W_g is the head dim."""
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    """Every parameter: (path, shape, init), as the port's tree; weights
    N(0, 1/fan_in) (a conv's fan-in its taps), embedding N(0, 0.02^2),
    norm scales 1, dt_bias and b_g 0, the A_log parameter N(0,
    a_log_std^2), the selection bias N(0, bias_std^2). ``num_experts``
    experts are held."""
    v, d, h = cfg["vocab_size"], cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    r, f, e = (cfg["kv_lora_rank"], cfg["moe_intermediate_size"],
               cfg["num_experts"])
    fs = f * cfg["num_shared_experts"]
    kh, kd, taps = kda_dims(cfg)
    hk = kh * kd

    def w(*path, shape):
        return (path, shape, ("normal", 1 / math.sqrt(shape[-2])))

    def zeros(*path, shape):
        return (path, shape, ("normal", 0.0))

    out = [(("embed",), (v, d), ("normal", 0.02)), w("unembed", shape=(d, v)),
           (("final_norm",), (d,), ("ones",))]
    for i in range(cfg["num_hidden_layers"]):
        b = ("blocks", i)
        a = b + ("attn",)
        out += [(b + ("ln1_scale",), (d,), ("ones",)),
                (b + ("ln2_scale",), (d,), ("ones",))]
        if is_kda_block(cfg, i):
            out += [w(*a, "wq", shape=(d, hk)), w(*a, "wk", shape=(d, hk)),
                    w(*a, "wv", shape=(d, hk)),
                    w(*a, "q_conv", shape=(taps, hk)),
                    w(*a, "k_conv", shape=(taps, hk)),
                    w(*a, "v_conv", shape=(taps, hk)),
                    w(*a, "wf_a", shape=(d, kd)), w(*a, "wf_b", shape=(kd, hk)),
                    (a + ("a_log",), (kh,), ("normal", cfg["a_log_std"])),
                    zeros(*a, "dt_bias", shape=(hk,)),
                    w(*a, "wb", shape=(d, kh)),
                    w(*a, "wg_a", shape=(d, kd)), w(*a, "wg_b", shape=(kd, hk)),
                    zeros(*a, "g_bias", shape=(hk,)),
                    (a + ("o_norm",), (kd,), ("ones",)),
                    w(*a, "wo", shape=(hk, d))]
        else:
            out += [w(*a, "wq", shape=(d, h * (nope + rd))),
                    w(*a, "wkv_a", shape=(d, r + rd)),
                    (a + ("kv_norm",), (r,), ("ones",)),
                    w(*a, "wkv_b", shape=(r, h * (nope + vd))),
                    w(*a, "wo", shape=(h * vd, d))]
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


# ---------------------------------------------------------------------------
# Kimi Delta Attention
# ---------------------------------------------------------------------------

def kda_recurrent(q, k, v, g, beta, mm=None):
    """o [B, S, H, dv] of the definition, token by token: S_t = (I -
    beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T, o_t =
    S_t^T q_t; q, k, g [B, S, H, dk], v [B, S, H, dv], beta [B, S, H].
    `mm` is not used (kda_chunked's signature)."""
    b, s, h, dk = q.shape
    state = q.new_zeros(b, h, dk, v.shape[-1])
    out = []
    for t in range(s):
        kt, bt = k[:, t], beta[:, t, :, None, None]
        state = torch.exp(g[:, t])[..., None] * state
        state = (state - bt * kt[..., None] * (kt[..., None, :] @ state)
                 + bt * kt[..., None] * v[:, t, :, None, :])
        out.append((q[:, t, :, None, :] @ state)[..., 0, :])
    return torch.stack(out, 1)


def _chunk(q, k, v, g, beta, state, mm):
    """One chunk of rows [B, H, C, .] from `state` [B, H, dk, dv]: (o
    [B, H, C, dv], the state after it). Within the chunk, with G the
    cumulative log-decay, each pair's decay exp(G_r - G_i) is taken
    channel by channel (never positive for i <= r, so nothing
    overflows), and the delta rule's rows are solved as one unit lower
    triangular system: (I + Diag(beta) A) U = Diag(beta) (v - (k exp G)
    S), A[r, i] = sum_c k_rc k_ic exp(G_rc - G_ic), i < r."""
    c = q.shape[-2]
    G = g.cumsum(-2)
    diff = G[..., :, None, :] - G[..., None, :, :]          # [.., r, i, dk]
    upper = torch.ones(c, c, dtype=torch.bool, device=q.device).triu(1)
    decay = torch.exp(diff.masked_fill(upper[..., None], float("-inf")))
    kd = k[..., None, :, :] * decay                         # k_i exp(G_r - G_i)
    strict = torch.ones(c, c, dtype=torch.bool, device=q.device).tril(-1)
    A = (k[..., :, None, :] * kd).sum(-1).masked_fill(~strict, 0.0)
    P = (q[..., :, None, :] * kd).sum(-1)
    M = torch.eye(c, device=q.device) + beta[..., None] * A
    rhs = beta[..., None] * (v - mm(k * torch.exp(G), state))
    u = torch.linalg.solve_triangular(M, rhs, upper=False, unitriangular=True)
    o = mm(q * torch.exp(G), state) + mm(P, u)
    last = G[..., -1:, :]
    state = (torch.exp(last).transpose(-1, -2) * state
             + mm((k * torch.exp(last - G)).transpose(-1, -2), u))
    return o, state


def kda_chunked(q, k, v, g, beta, mm=torch.matmul):
    """kda_recurrent's o by 64-token chunks (the last one shorter), each
    under activation checkpointing, the state carried between them."""
    b, s, h, dk = q.shape
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, g))
    bh = beta.transpose(1, 2)
    state = q.new_zeros(b, h, dk, v.shape[-1])
    parts = []
    for start in range(0, s, CHUNK):
        end = min(s, start + CHUNK)
        o, state = checkpoint(_chunk, qh[:, :, start:end], kh[:, :, start:end],
                              vh[:, :, start:end], gh[:, :, start:end],
                              bh[:, :, start:end], state, mm,
                              use_reentrant=False)
        parts.append(o)
    return torch.cat(parts, 2).transpose(1, 2)


def causal_conv(x, w):
    """y_t = sum_j w[j] x_{t - taps + 1 + j} per channel; x [B, S, C], w
    [taps, C]."""
    taps, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, taps - 1, 0))
    return sum(xp[:, j:j + s] * w[j] for j in range(taps))


def l2norm(x, eps):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps)


def kda_layer(cfg, p, h, mm, kda=kda_chunked):
    b, s, _ = h.shape
    heads, dk, _ = kda_dims(cfg)
    q, k, v = (F.silu(causal_conv(mm(h, p[f"w{n}"]), p[f"{n}_conv"]))
               .view(b, s, heads, dk) for n in ("q", "k", "v"))
    q = l2norm(q, cfg["kda_l2_eps"]) / math.sqrt(dk)
    k = l2norm(k, cfg["kda_l2_eps"])
    f = mm(mm(h, p["wf_a"]), p["wf_b"]) + p["dt_bias"]
    a = torch.exp(cfg["a_log_offset"] + p["a_log"])
    g = -a[:, None] * F.softplus(f.view(b, s, heads, dk))
    beta = torch.sigmoid(mm(h, p["wb"]))
    o = kda(q, k, v, g, beta, mm)
    gate = torch.sigmoid(mm(mm(h, p["wg_a"]), p["wg_b"]) + p["g_bias"])
    y = rmsnorm(o, p["o_norm"], cfg["rms_norm_eps"]) * gate.view(o.shape)
    return mm(y.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLA (NoPE), the FFNs, the model
# ---------------------------------------------------------------------------

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
    k = torch.cat([kv[..., :nope],
                   k_pe.view(b, s, 1, rd).expand(b, s, heads, rd)], -1)
    o = attention(q, k, kv[..., nope:], mm)
    return mm(o.reshape(b, s, heads * vd), p["wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(cfg, p, h, mm):
    """(out, balance loss) of the MoE FFN on the normed h over the held
    experts [lo, lo + num_experts)."""
    b, s, d = h.shape
    k, n_router = cfg["num_experts_per_token"], cfg["router_experts"]
    scores = torch.sigmoid(mm(h, p["router"]))
    chosen = torch.topk(scores + p["bias"], k, dim=-1).indices
    picked = scores.gather(-1, chosen)
    gates = (cfg["routed_scaling_factor"] * picked
             / picked.sum(-1, keepdim=True)).reshape(-1, k)
    x = h.reshape(-1, d)
    out = swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"], mm)
    lo = cfg["experts_held"][0]
    flat = chosen.reshape(-1, k)
    for j in range(cfg["num_experts"]):
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
    h = rmsnorm(x, p["ln1_scale"], eps)
    mixer = kda_layer if is_kda_block(cfg, i) else mla
    x = x + mixer(cfg, p["attn"], h, mm)
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
