"""DeepSeek-V3-family LM (the third model family; Moonlight-16B-A3B is one
at its published widths): multi-head latent attention (``mla.py``) in
every block, a dense SwiGLU FFN in the first ``first_dense`` blocks and a
fine-grained MoE in the rest (``moe.topk_ffn``: sigmoid scores, top-k of
scores plus a selection bias, normalised and scaled gates, dropless
routing over the experts held here, a shared SwiGLU expert), RMSNorm with
a learned scale everywhere (the head's too) and untied embeddings
(arXiv:2412.19437 §2.1; the Moonlight config's ``deepseek_v3``).

A ``model.TransformerLM`` subclass through ``make_block``; its train step
is ``model.build_train_step`` with the LM loss plus ``aux_weight`` times
the sum of the MoE blocks' sequence-wise balance losses. Parameters are
fp32 masters in the [in, out] layout; matmuls run in ``cfg.dtype``, the
router in fp32. Each MoE block holds the routed experts of
``experts_held`` (a range of the router's ``n_routed``), as one chip of
an expert-parallel deployment holds its share, and computes their part
of the layer only; there is no exchange. The selection bias is a buffer:
the step trains every parameter by SGD and leaves the bias as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from tpu_dra_torch.workloads import model as _dense
from tpu_dra_torch.workloads.mla import mla
from tpu_dra_torch.workloads.model import ModelConfig
from tpu_dra_torch.workloads.moe import swiglu, topk_ffn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DSV3Config(ModelConfig):
    norm_eps: float = 1e-5
    qk_nope_dim: int = 32
    qk_rope_dim: int = 16
    v_head_dim: int = 32
    kv_rank: int = 32
    rope_theta: float = 50000.0
    first_dense: int = 1          # blocks [0, first_dense) are dense
    moe_d_ff: int = 64            # each routed expert's (and shared unit's)
    n_routed: int = 16            # the router's experts
    experts_held: Tuple[int, int] = (0, 16)   # [lo, hi) of them held here
    top_k: int = 3
    n_shared: int = 2
    routed_scale: float = 2.446
    aux_weight: float = 1e-4

    def is_moe_block(self, i: int) -> bool:
        return i >= self.first_dense


def init_params(cfg: DSV3Config, generator: torch.Generator,
                device="cuda", bias_std: float = 0.01) -> Params:
    """fp32 params drawn from `generator` on its own device: weights
    N(0, 1/fan_in), the embedding N(0, 0.02^2), norm scales 1, the
    selection bias N(0, bias_std^2)."""
    device = _dense.resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    def dense(*shape):
        return normal(shape, 1 / math.sqrt(shape[-2]))

    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    held = cfg.experts_held[1] - cfg.experts_held[0]
    f, fs = cfg.moe_d_ff, cfg.moe_d_ff * cfg.n_shared
    params: Params = {"embed": normal((cfg.vocab, d), 0.02),
                      "unembed": dense(d, cfg.vocab),
                      "final_norm": torch.ones(d), "blocks": []}
    for i in range(cfg.n_layers):
        block = {
            "ln1_scale": torch.ones(d), "ln2_scale": torch.ones(d),
            "attn": {"wq": dense(d, h * qk),
                     "wkv_a": dense(d, cfg.kv_rank + cfg.qk_rope_dim),
                     "kv_norm": torch.ones(cfg.kv_rank),
                     "wkv_b": dense(cfg.kv_rank,
                                    h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                     "wo": dense(h * cfg.v_head_dim, d)}}
        if cfg.is_moe_block(i):
            block["moe"] = {
                "router": dense(d, cfg.n_routed),
                "bias": normal((cfg.n_routed,), bias_std),
                "w_gate": dense(held, d, f), "w_up": dense(held, d, f),
                "w_down": dense(held, f, d),
                "shared_gate": dense(d, fs), "shared_up": dense(d, fs),
                "shared_down": dense(fs, d)}
        else:
            block["ffn"] = {"w_gate": dense(d, cfg.d_ff),
                            "w_up": dense(d, cfg.d_ff),
                            "w_down": dense(cfg.d_ff, d)}
        params["blocks"].append(block)
    return _dense.tree_map(lambda x: x.to(device), params)


def _module_of(leaves: Dict[str, torch.Tensor], buffers=()) -> nn.Module:
    m = nn.Module()
    for name, leaf in leaves.items():
        if name in buffers:
            m.register_buffer(name, leaf)
        else:
            m.register_parameter(name, nn.Parameter(leaf))
    return m


class DSV3Block(nn.Module):
    """Pre-norm MLA and a dense SwiGLU FFN or the MoE FFN. forward(x) ->
    (x, the block's balance loss; None for a dense block)."""

    def __init__(self, cfg: DSV3Config, leaves, moe: bool):
        super().__init__()
        self.cfg = cfg
        self.ln1_scale = nn.Parameter(leaves["ln1_scale"])
        self.ln2_scale = nn.Parameter(leaves["ln2_scale"])
        self.attn = _module_of(leaves["attn"])
        if moe:
            self.moe = _module_of(leaves["moe"], buffers=("bias",))
        else:
            self.ffn = _module_of(leaves["ffn"])

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        h = _dense._rmsnorm(x, self.ln1_scale, cfg.norm_eps)
        x = x + mla(cfg, dict(self.attn.named_parameters()), h)
        h = _dense._rmsnorm(x, self.ln2_scale, cfg.norm_eps)
        if not hasattr(self, "moe"):
            f = self.ffn
            w_in = torch.cat([f.w_gate, f.w_up], -1).to(cfg.dtype)
            return x + swiglu(h, w_in, f.w_down.to(cfg.dtype)), None
        params = {**dict(self.moe.named_parameters()),
                  "bias": self.moe.bias}
        out, aux = topk_ffn(params, h, top_k=cfg.top_k,
                            experts=range(*cfg.experts_held),
                            scale=cfg.routed_scale, compute_dtype=cfg.dtype)
        return x + out, aux


class DSV3LM(_dense.TransformerLM):
    """forward(tokens) -> (fp32 logits, the summed balance losses)."""

    def __init__(self, cfg: DSV3Config, params: Params, mesh=None):
        if mesh is not None:
            raise ValueError("the DeepSeek-V3 family runs on one device; "
                             "experts_held gives this chip's share")
        super().__init__(cfg, params)
        self.final_norm = nn.Parameter(params["final_norm"])

    def make_block(self, i: int, leaves) -> nn.Module:
        return DSV3Block(self.cfg, leaves, self.cfg.is_moe_block(i))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _dense._rmsnorm(x, self.final_norm, cfg.norm_eps)
        return x @ self.unembed.to(cfg.dtype)

    def trunk(self, tokens: torch.Tensor):
        x = self.embed_tokens(tokens)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            x, aux = self.block_call(block, x)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    def forward(self, tokens: torch.Tensor):
        x, aux = self.trunk(tokens)
        return self.head(x).float(), aux


def loss_fn(model: DSV3LM, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (model.lm_loss) plus aux_weight
    times the summed balance losses."""
    nll, aux = _dense.lm_loss(model, tokens)
    return nll + model.cfg.aux_weight * aux


def make_train_step(model: DSV3LM, lr: float = 1e-3):
    """SGD step via the shared builder (model.build_train_step)."""
    return _dense.build_train_step(model, lr, loss_fn)
