"""Kimi Linear-family LM (the fifth model family; its config.json,
``kimi_linear``; arXiv:2510.26692): hybrid token mixing, three Kimi Delta
Attention layers to one MLA layer, over a fine-grained MoE with a shared
expert.

- Token mixer, per layer by ``kda_pattern`` (1 KDA, 0 MLA): a KDA layer
  (``kda.kda``: short convs, L2-normed q and k, a per-channel decay and
  the gated delta rule, a gated RMSNorm; H ``kda_heads`` of
  ``kda_head_dim``) or an MLA layer (``mla.mla`` in its NoPE form: q.k
  128 + 64 and v 128 without rotation, kv rank 512, no q
  down-projection; softmax scale 1/sqrt(192)).
- FFN: a dense SwiGLU in the first ``first_dense`` blocks; in the rest
  ``moe.topk_ffn`` over the experts held here (sigmoid scores, top-k of
  scores plus a fixed selection bias, gates ``routed_scale`` s_i / sum of
  the selected s, a shared SwiGLU expert), with the sequence-wise
  balance loss weighted by ``aux_weight``.
- RMSNorm with learned scales (the head's too), untied embeddings.

A ``model.TransformerLM`` subclass through ``make_block`` (as
dsv3_model.py, whose head, trunk and loss it shares); its train step is
``model.build_train_step``. Parameters are fp32 masters in the [in, out]
layout; matmuls run in ``cfg.dtype``, the router, decays and gates in
fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from tpu_dra_torch.workloads import dsv3_model
from tpu_dra_torch.workloads._mixer_kernels import TAPS
from tpu_dra_torch.workloads import model as _dense
from tpu_dra_torch.workloads.dsv3_model import DSV3Config
from tpu_dra_torch.workloads.kda import kda
from tpu_dra_torch.workloads.mla import mla
from tpu_dra_torch.workloads.moe import swiglu, topk_ffn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KimiConfig(DSV3Config):
    mla_use_nope: bool = True
    n_shared: int = 1
    kda_pattern: Tuple[int, ...] = (1, 0)   # per block: 1 KDA, 0 MLA
    kda_heads: int = 4
    kda_head_dim: int = 16        # dk = dv
    kda_rank: int = 16            # W_f's and W_g's low rank
    l2_eps: float = 1e-6
    a_log_offset: float = math.log(4.0)   # A_log = offset + a_log

    def is_kda_block(self, i: int) -> bool:
        return bool(self.kda_pattern[i])


def init_params(cfg: KimiConfig, generator: torch.Generator, device="cuda",
                bias_std: float = 0.01, a_log_std: float = 0.69) -> Params:
    """fp32 params drawn from `generator` on its own device: weights
    N(0, 1/fan_in) (the convs' fan-in their taps), the embedding N(0,
    0.02^2), norm scales 1, dt_bias and b_g 0, a_log N(0, a_log_std^2),
    the selection bias N(0, bias_std^2)."""
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
    hk, rank = cfg.kda_heads * cfg.kda_head_dim, cfg.kda_rank
    params: Params = {"embed": normal((cfg.vocab, d), 0.02),
                      "unembed": dense(d, cfg.vocab),
                      "final_norm": torch.ones(d), "blocks": []}
    for i in range(cfg.n_layers):
        if cfg.is_kda_block(i):
            attn = {"wq": dense(d, hk), "wk": dense(d, hk), "wv": dense(d, hk),
                    "q_conv": dense(TAPS, hk),
                    "k_conv": dense(TAPS, hk),
                    "v_conv": dense(TAPS, hk),
                    "wf_a": dense(d, rank), "wf_b": dense(rank, hk),
                    "a_log": normal((cfg.kda_heads,), a_log_std),
                    "dt_bias": torch.zeros(hk), "wb": dense(d, cfg.kda_heads),
                    "wg_a": dense(d, rank), "wg_b": dense(rank, hk),
                    "g_bias": torch.zeros(hk),
                    "o_norm": torch.ones(cfg.kda_head_dim),
                    "wo": dense(hk, d)}
        else:
            attn = {"wq": dense(d, h * qk),
                    "wkv_a": dense(d, cfg.kv_rank + cfg.qk_rope_dim),
                    "kv_norm": torch.ones(cfg.kv_rank),
                    "wkv_b": dense(cfg.kv_rank,
                                   h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                    "wo": dense(h * cfg.v_head_dim, d)}
        block = {"ln1_scale": torch.ones(d), "ln2_scale": torch.ones(d),
                 "attn": attn}
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


class KimiBlock(nn.Module):
    """Pre-norm KDA or MLA, and a dense SwiGLU FFN or the MoE FFN.
    forward(x) -> (x, the block's balance loss; None for a dense block)."""

    def __init__(self, cfg: KimiConfig, leaves, i: int):
        super().__init__()
        self.cfg = cfg
        self.mixer = kda if cfg.is_kda_block(i) else mla
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
        x = x + self.mixer(cfg, dict(self.attn.named_parameters()), h)
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


class KimiLM(dsv3_model.DSV3LM):
    """forward(tokens) -> (fp32 logits, the summed balance losses)."""

    def __init__(self, cfg: KimiConfig, params: Params, mesh=None):
        if len(cfg.kda_pattern) != cfg.n_layers:
            raise ValueError(f"kda_pattern has {len(cfg.kda_pattern)} "
                             f"entries for {cfg.n_layers} layers")
        super().__init__(cfg, params, mesh)

    def make_block(self, i: int, leaves) -> nn.Module:
        return KimiBlock(self.cfg, leaves, i)


loss_fn = dsv3_model.loss_fn


def make_train_step(model: KimiLM, lr: float = 1e-3):
    """SGD step via the shared builder (model.build_train_step)."""
    return _dense.build_train_step(model, lr, loss_fn)
