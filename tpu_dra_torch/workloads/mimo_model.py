"""MiMo-V2-Flash-family LM (the fourth model family; its config.json,
``mimo_v2_flash``): hybrid attention, five sliding-window layers to one
global, over a fine-grained MoE.

- Attention, per layer: q = h W_q (H heads of q.k dim Dqk), k = h W_k and
  v = h W_v (Hkv heads of Dqk and Dv: grouped-query attention, each K/V
  head read by H / Hkv query heads); rope on the first ``rope_dims`` dims
  of q and k (half-split pairing, ``mla.rope``), at ``rope_theta`` in the
  global layers and ``swa_rope_theta`` in the window layers; causal
  softmax(q k^T / sqrt(Dqk)) v, the window layers over the last
  ``window`` keys of each query (i - W < j <= i) and with ``swa_kv_heads``
  K/V heads, the global layers over every earlier key with ``n_kv_heads``;
  o W_o. ``hybrid_pattern[i]`` is 1 for a window layer, 0 for a global
  one.
- A window layer's heads each have a learned attention sink, a logit s_h
  that joins every row's softmax and takes its share of the mass but adds
  no value: o' = o Z / (Z + e^s_h) = o sigmoid(lse - s_h), with lse the
  row's logsumexp over its keys (``attend(..., with_lse=True)``: the
  kernels' lse is differentiable, so the sink's gradient reaches it
  through the fused backward's dlse). The sink logit is ``sink_offset``
  plus the learned per-head ``sinks``.
- Every layer's output is scaled by ``value_scale`` before W_o (the
  config's ``attention_value_scale``, which scales v: o is linear in v).
- FFN: a dense SwiGLU in the first ``first_dense`` blocks; in the rest
  ``moe.topk_ffn`` over the experts held here (sigmoid scores, top-k of
  scores plus a fixed selection bias, gates s_i / sum of the selected s,
  no routed scale, no shared expert), with the sequence-wise balance
  loss weighted by ``aux_weight``.
- RMSNorm with learned scales (the head's too), untied embeddings.

A ``model.TransformerLM`` subclass through ``make_block`` (as
dsv3_model.py, whose head, trunk and loss it shares); its train step is
``model.build_train_step``. On a card every attention call runs the
(192, 128) Hopper kernels with grouped K/V heads and, in a window layer,
the band: rope is applied here to the roped dims (rope=False), and K and
V are never expanded to the query heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from tpu_dra_torch.infra.trace import device_span
from tpu_dra_torch.workloads import dsv3_model
from tpu_dra_torch.workloads import model as _dense
from tpu_dra_torch.workloads.flashattention import attend
from tpu_dra_torch.workloads.mla import rope, rope_tables
from tpu_dra_torch.workloads.model import ModelConfig
from tpu_dra_torch.workloads.moe import swiglu, topk_ffn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MiMoConfig(ModelConfig):
    norm_eps: float = 1e-5
    n_kv_heads: int = 2           # the global layers' K/V heads
    swa_kv_heads: int = 4         # the window layers' K/V heads
    qk_head_dim: int = 48
    v_head_dim: int = 32
    rope_dims: int = 16           # q's and k's leading dims that are roped
    rope_theta: float = 5e6
    swa_rope_theta: float = 1e4
    window: int = 16
    hybrid_pattern: Tuple[int, ...] = (0, 1)   # per block: 1 window, 0 global
    sink_offset: float = 0.0
    value_scale: float = 0.707
    first_dense: int = 1          # blocks [0, first_dense) are dense
    moe_d_ff: int = 64
    n_routed: int = 16            # the router's experts
    experts_held: Tuple[int, int] = (0, 16)   # [lo, hi) of them held here
    top_k: int = 4
    aux_weight: float = 1e-4

    def is_moe_block(self, i: int) -> bool:
        return i >= self.first_dense

    def is_window_block(self, i: int) -> bool:
        return bool(self.hybrid_pattern[i])

    def kv_heads(self, i: int) -> int:
        return self.swa_kv_heads if self.is_window_block(i) else self.n_kv_heads


def init_params(cfg: MiMoConfig, generator: torch.Generator,
                device="cuda", bias_std: float = 0.01) -> Params:
    """fp32 params drawn from `generator` on its own device: weights
    N(0, 1/fan_in), the embedding N(0, 0.02^2), norm scales 1, the
    selection bias N(0, bias_std^2), the window layers' sinks N(0, 1)."""
    device = _dense.resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    def dense(*shape):
        return normal(shape, 1 / math.sqrt(shape[-2]))

    d, h = cfg.d_model, cfg.n_heads
    held = cfg.experts_held[1] - cfg.experts_held[0]
    params: Params = {"embed": normal((cfg.vocab, d), 0.02),
                      "unembed": dense(d, cfg.vocab),
                      "final_norm": torch.ones(d), "blocks": []}
    for i in range(cfg.n_layers):
        hkv = cfg.kv_heads(i)
        attn = {"wq": dense(d, h * cfg.qk_head_dim),
                "wk": dense(d, hkv * cfg.qk_head_dim),
                "wv": dense(d, hkv * cfg.v_head_dim),
                "wo": dense(h * cfg.v_head_dim, d)}
        if cfg.is_window_block(i):
            attn["sinks"] = normal((h,), 1.0)
        block = {"ln1_scale": torch.ones(d), "ln2_scale": torch.ones(d),
                 "attn": attn}
        if cfg.is_moe_block(i):
            block["moe"] = {
                "router": dense(d, cfg.n_routed),
                "bias": normal((cfg.n_routed,), bias_std),
                "w_gate": dense(held, d, cfg.moe_d_ff),
                "w_up": dense(held, d, cfg.moe_d_ff),
                "w_down": dense(held, cfg.moe_d_ff, d)}
        else:
            block["ffn"] = {"w_gate": dense(d, cfg.d_ff),
                            "w_up": dense(d, cfg.d_ff),
                            "w_down": dense(cfg.d_ff, d)}
        params["blocks"].append(block)
    return _dense.tree_map(lambda x: x.to(device), params)


def hybrid_attention(cfg: MiMoConfig, p, h: torch.Tensor,
                     window: int) -> torch.Tensor:
    """o W_o [B, S, D] of the normed h [B, S, D]: a window layer's
    (window > 0; `p` holds its ``sinks``) or a global layer's (window 0)
    attention; `p` holds wq [D, H Dqk], wk [D, Hkv Dqk], wv [D, Hkv Dv]
    and wo [H Dv, D] (fp32 masters, [in, out]).

    Under torch.profiler a window layer's attend call and its sink
    rescale are the range ``attention.window``."""
    cd = cfg.dtype
    b, s, _ = h.shape
    heads, dqk, r = cfg.n_heads, cfg.qk_head_dim, cfg.rope_dims
    q = (h @ p["wq"].to(cd)).view(b, s, heads, dqk)
    k = (h @ p["wk"].to(cd)).view(b, s, -1, dqk)
    v = (h @ p["wv"].to(cd)).view(b, s, -1, cfg.v_head_dim)
    theta = cfg.swa_rope_theta if window else cfg.rope_theta
    cos, sin = rope_tables(s, r, theta, h.device)
    q = torch.cat([rope(q[..., :r], cos, sin), q[..., r:]], -1)
    k = torch.cat([rope(k[..., :r], cos, sin), k[..., r:]], -1)
    if window:
        with device_span("attention.window"):
            o, lse = attend(q, k, v, causal=True, impl=cfg.attn_impl,
                            window=window, with_lse=True)
            # The sink's share of each row's mass, and the value scale.
            keep = torch.sigmoid(lse - (cfg.sink_offset + p["sinks"])[:, None])
            o = (o.float() * (cfg.value_scale * keep.transpose(1, 2)[..., None])
                 ).to(cd)
    else:
        o = attend(q, k, v, causal=True, impl=cfg.attn_impl)
        o = o * cfg.value_scale
    return o.reshape(b, s, heads * cfg.v_head_dim) @ p["wo"].to(cd)


class MiMoBlock(nn.Module):
    """Pre-norm hybrid attention and a dense SwiGLU FFN or the MoE FFN.
    forward(x) -> (x, the block's balance loss; None for a dense block)."""

    def __init__(self, cfg: MiMoConfig, leaves, i: int):
        super().__init__()
        self.cfg = cfg
        self.window = cfg.window if cfg.is_window_block(i) else 0
        self.ln1_scale = nn.Parameter(leaves["ln1_scale"])
        self.ln2_scale = nn.Parameter(leaves["ln2_scale"])
        self.attn = dsv3_model._module_of(leaves["attn"])
        if cfg.is_moe_block(i):
            self.moe = dsv3_model._module_of(leaves["moe"], buffers=("bias",))
        else:
            self.ffn = dsv3_model._module_of(leaves["ffn"])

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        h = _dense._rmsnorm(x, self.ln1_scale, cfg.norm_eps)
        x = x + hybrid_attention(cfg, dict(self.attn.named_parameters()), h,
                                 self.window)
        h = _dense._rmsnorm(x, self.ln2_scale, cfg.norm_eps)
        if not hasattr(self, "moe"):
            f = self.ffn
            w_in = torch.cat([f.w_gate, f.w_up], -1).to(cfg.dtype)
            return x + swiglu(h, w_in, f.w_down.to(cfg.dtype)), None
        params = {**dict(self.moe.named_parameters()),
                  "bias": self.moe.bias}
        out, aux = topk_ffn(params, h, top_k=cfg.top_k,
                            experts=range(*cfg.experts_held), scale=1.0,
                            compute_dtype=cfg.dtype)
        return x + out, aux


class MiMoLM(dsv3_model.DSV3LM):
    """forward(tokens) -> (fp32 logits, the summed balance losses)."""

    def __init__(self, cfg: MiMoConfig, params: Params, mesh=None):
        if len(cfg.hybrid_pattern) != cfg.n_layers:
            raise ValueError(f"hybrid_pattern has {len(cfg.hybrid_pattern)} "
                             f"entries for {cfg.n_layers} layers")
        super().__init__(cfg, params, mesh)

    def make_block(self, i: int, leaves) -> nn.Module:
        return MiMoBlock(self.cfg, leaves, i)


loss_fn = dsv3_model.loss_fn


def make_train_step(model: MiMoLM, lr: float = 1e-3):
    """SGD step via the shared builder (model.build_train_step)."""
    return _dense.build_train_step(model, lr, loss_fn)
