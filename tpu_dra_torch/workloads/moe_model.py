"""MoE transformer LM — the second model family (counterpart of
tpu_dra/workloads/moe_model.py).

A sparse-FFN sibling of ``model.TransformerLM``: the same attention
sublayer (the CUDA flash kernels with fused RoPE), but every
``moe_every``-th block swaps the dense FFN for the Switch-style top-1
expert FFN of ``moe.py``. On a ('data', 'model') mesh the experts shard
their leading dim over 'model' (EP rides the TP axis, the reference's
layout), routing is global over 'data', and the router's aux
(load-balancing) loss joins the LM loss with a small weight. The train
step is the dense model's builder (``model.build_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import model as _dense
from tpu_dra_torch.workloads.model import ModelConfig
from tpu_dra_torch.workloads.moe import expert_parallel_ffn, init_moe_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEModelConfig(ModelConfig):
    n_experts: int = 8
    moe_every: int = 2           # block i uses MoE iff i % moe_every == 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    def is_moe_block(self, i: int) -> bool:
        return i % self.moe_every == self.moe_every - 1


def init_params(cfg: MoEModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Dense-model params with MoE FFNs (fp32) swapped in on MoE blocks."""
    device = _dense.resolve_device(device)
    params = _dense.init_params(cfg, generator, device)
    for i, bp in enumerate(params["blocks"]):
        if cfg.is_moe_block(i):
            del bp["w_up"], bp["w_down"]
            bp["moe"] = init_moe_params(generator, cfg.d_model, cfg.d_ff,
                                        cfg.n_experts, device=device)
    return params


def param_specs(cfg: MoEModelConfig) -> Params:
    """Dense specs + the experts' leading dim on 'model' (EP on the TP
    axis); the router is replicated."""
    specs = _dense.param_specs(cfg)
    for i, bs in enumerate(specs["blocks"]):
        if cfg.is_moe_block(i):
            del bs["w_up"], bs["w_down"]
            bs["moe"] = {"router": (None, None),
                         "w_up": ("model", None, None),
                         "w_down": ("model", None, None)}
    return specs


def shard_params(params: Params, mesh, cfg: MoEModelConfig) -> Params:
    _, tp, _ = _dist.axis_of(mesh, "model")
    if cfg.n_experts % tp:
        raise ValueError(f"n_experts={cfg.n_experts} does not divide by the "
                         f"'model' axis' {tp} ranks")
    return _dense.shard_params(params, mesh, cfg, param_specs(cfg))


def unshard_params(shards, cfg: MoEModelConfig) -> Params:
    return _dense.unshard_params(shards, cfg, param_specs(cfg))


class MoEBlock(_dense.Block):
    """The dense block's attention sublayer; the FFN half is the expert
    layer (this rank's experts on a 'model' axis). Returns (x, aux)."""

    def __init__(self, cfg: MoEModelConfig, leaves, mesh=None):
        super().__init__(cfg, leaves, mesh)
        self.moe = nn.Module()
        for name, leaf in leaves["moe"].items():
            self.moe.register_parameter(name, nn.Parameter(leaf))
        self.data, _, _ = _dist.axis_of(mesh, "data")

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        x = self.attention_sublayer(x)
        h = _dense._rmsnorm(x, self.ln2_scale, cfg.norm_eps)
        out, aux = expert_parallel_ffn(
            {"router": self.moe.router, "w_up": self.moe.w_up,
             "w_down": self.moe.w_down}, h, group=self.tp,
            capacity_factor=cfg.capacity_factor, compute_dtype=cfg.dtype,
            data_group=self.data)
        return x + out, aux


class MoETransformerLM(_dense.TransformerLM):
    """forward(tokens) -> (logits, aux_loss)."""

    def make_block(self, i: int, leaves) -> nn.Module:
        if self.cfg.is_moe_block(i):
            return MoEBlock(self.cfg, leaves, self.mesh)
        return _dense.Block(self.cfg, leaves, self.mesh)

    def trunk(self, tokens: torch.Tensor):
        x = self.embed_tokens(tokens)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.blocks):
            if self.cfg.is_moe_block(i):
                x, aux = self.block_call(block, x)
                aux_total = aux_total + aux
            else:
                x = self.block_call(block, x)
        return x, aux_total

    def forward(self, tokens: torch.Tensor):
        x, aux = self.trunk(tokens)
        return self.head(x).float(), aux


def loss_fn(model: MoETransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """LM cross-entropy (the dense model's, model.lm_loss) plus the
    weighted router load-balancing aux."""
    nll, aux = _dense.lm_loss(model, tokens)
    return nll + model.cfg.router_aux_weight * aux


def make_train_step(model: MoETransformerLM, lr: float = 1e-3):
    """SGD step via the shared builder (model.build_train_step)."""
    return _dense.build_train_step(model, lr, loss_fn)

