"""Plain float32 reference of the MoE LM train step: the dense
reference (``transformer_lm``) with every ``moe_every``-th block's FFN a
Switch-style top-1 mixture of experts (Fedus et al., arXiv:2101.03961):

- router: logits = h @ W_router (float32), probs = softmax, each token's
  expert the first argmax, its gate that expert's probability;
- capacity = max(1, int(capacity_factor * tokens / n_experts)); an
  expert takes its tokens in (batch, position) order and drops those past
  its capacity (a dropped token's FFN output is zero: the residual
  carries it);
- expert e: tanh-GELU(x W_up[e]) W_down[e], times the gate;
- load-balancing loss per MoE block: n_experts^2 * sum_e (share of tokens
  routed to e, before capacity) * (mean router probability of e); the
  train loss adds ``router_aux_weight`` times their sum.

The experts gather their tokens by index and scatter the results back;
the router's choices are the reference's own.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import precision as prec
from portbench.reference import transformer_lm as dense


def is_moe_block(cfg: Dict[str, Any], i: int) -> bool:
    every = cfg["moe_every"]
    return i % every == every - 1


def leaves(cfg: Dict[str, Any]) -> List[weights.Leaf]:
    d, f, e = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    out = []
    for path, shape, init in dense.leaves(cfg):
        if path[0] == "blocks" and is_moe_block(cfg, path[1]) \
                and path[2] in ("w_up", "w_down"):
            continue
        out.append((path, shape, init))
    for i in range(cfg["n_layers"]):
        if is_moe_block(cfg, i):
            out += [
                (("blocks", i, "moe", "router"), (d, e),
                 ("normal", 1 / math.sqrt(d))),
                (("blocks", i, "moe", "w_up"), (e, d, f),
                 ("normal", 1 / math.sqrt(d))),
                (("blocks", i, "moe", "w_down"), (e, f, d),
                 ("normal", 1 / math.sqrt(f))),
            ]
    return out


def capacity(cfg: Dict[str, Any], tokens: int) -> int:
    return max(1, int(cfg["capacity_factor"] * tokens / cfg["n_experts"]))


def moe_ffn(cfg, p, h, mm):
    """(out [B, S, D], aux) of the expert layer on the normed h."""
    b, s, d = h.shape
    e = cfg["n_experts"]
    x = h.reshape(-1, d)
    n = x.shape[0]
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    expert = probs.argmax(-1)
    gate = probs.gather(-1, expert[:, None])[:, 0]
    chosen = F.one_hot(expert, e)
    position = (torch.cumsum(chosen, 0) * chosen).sum(-1) - 1
    kept = position < capacity(cfg, n)
    out = torch.zeros_like(x)
    for j in range(e):
        idx = torch.nonzero((expert == j) & kept)[:, 0]
        if idx.numel():
            y = mm(F.gelu(mm(x[idx], p["w_up"][j]), approximate="tanh"),
                   p["w_down"][j])
            out = out.index_add(0, idx, y * gate[idx, None])
    share = chosen.float().mean(0)
    aux = (share * probs.mean(0)).sum() * e * e
    return out.view(b, s, d), aux


def loss(cfg: Dict[str, Any], params, tokens, precision: str = "fp32"):
    """Mean next-token cross-entropy plus the weighted router aux."""
    mm = prec.matmul(precision)
    x = params["embed"][tokens[:, :-1]]
    aux_total = torch.zeros((), device=x.device)
    for i, p in enumerate(params["blocks"]):
        x = dense.attention_sublayer(cfg, p, x, mm)
        if is_moe_block(cfg, i):
            out, aux = moe_ffn(cfg, p["moe"], dense.rmsnorm(x, p["ln2_scale"]),
                               mm)
            x = x + out
            aux_total = aux_total + aux
        else:
            x = dense.ffn(p, x, mm)
    nll = dense.head_nll(params, x, tokens[:, 1:], mm).mean()
    return nll + cfg["router_aux_weight"] * aux_total
