"""Transformer LM — the flagship workload, on one NVIDIA GPU.

Counterpart of tpu_dra/workloads/model.py: the same model, parameter tree
and numerics, in PyTorch's idiom.

- Parameters are fp32 masters in JAX's [in, out] layout (``x @ W``), so
  carrying weights across from the reference is a copy, never a
  transpose (``params_from_jax``). The forward casts them to
  ``cfg.dtype`` (bf16 or fp32) on the matmul path.
- Attention is ``flashattention.attend(..., causal=True, rope=True)``:
  the hand-written CUDA kernels on a CUDA tensor, in bf16 or fp32.
- The train step is plain SGD on one device, updated in place.

Not in this slice: rematerialization policies other than "none", and
the DP x TP mesh (``param_specs``/``shard_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_dra_torch.workloads.flashattention import attend

Params = Dict[str, Any]
BLOCK_LEAVES = ("ln1_scale", "ln2_scale", "wqkv", "wo", "w_up", "w_down")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card
    present raises: entry points never drop to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain path on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.bfloat16
    # Attention dispatch (flashattention.attend): "auto" = the CUDA
    # kernels on a CUDA tensor, the plain reference on a CPU one; tests
    # force "flash" / "reference". The tensor's device replaces the
    # reference's attn_platform.
    attn_impl: str = "auto"
    # Per-block rematerialization: only "none" in this slice.
    remat: str = "none"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """fp32 params (cast to cfg.dtype inside the forward), drawn from
    `generator` on its own device and moved to `device`. The draws are
    not the reference's for the same seed; params_from_jax carries the
    reference's own weights across."""
    device = resolve_device(device)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)

    def dense(shape):
        return normal(shape) / math.sqrt(shape[0])

    params: Params = {
        "embed": normal((cfg.vocab, cfg.d_model)) * 0.02,
        "unembed": dense((cfg.d_model, cfg.vocab)),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1_scale": torch.ones(cfg.d_model),
            "ln2_scale": torch.ones(cfg.d_model),
            "wqkv": dense((cfg.d_model, 3 * cfg.d_model)),
            "wo": dense((cfg.d_model, cfg.d_model)),
            "w_up": dense((cfg.d_model, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, cfg.d_model)),
        })
    return _to_device(params, device)


def _to_device(params: Params, device: torch.device) -> Params:
    return {
        "embed": params["embed"].to(device),
        "unembed": params["unembed"].to(device),
        "blocks": [{name: bp[name].to(device) for name in BLOCK_LEAVES}
                   for bp in params["blocks"]],
    }


def params_from_jax(tree: Params, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's parameter tree (tpu_dra.workloads.model.init_params,
    leaves as numpy arrays) as this model's fp32 params on `device`. Both
    keep [in, out] weights, so each leaf is a copy."""
    device = resolve_device(device)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"{cfg.n_layers}")

    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    return _to_device({
        "embed": leaf(tree["embed"]),
        "unembed": leaf(tree["unembed"]),
        "blocks": [{name: leaf(bp[name]) for name in BLOCK_LEAVES}
                   for bp in tree["blocks"]],
    }, device)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 variance, eps 1e-6, rounded to x.dtype before the scale — the
    reference's rounding points."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


class Block(nn.Module):
    """One pre-norm block; parameters named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in BLOCK_LEAVES:
            self.register_parameter(name, nn.Parameter(leaves[name]))

    def attention_sublayer(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        h = _rmsnorm(x, self.ln1_scale)
        qkv = h @ self.wqkv.to(cfg.dtype)
        # Views of the fused projection: the kernels read them in place.
        q, k, v = (t.view(b, s, cfg.n_heads, cfg.d_head)
                   for t in qkv.split(d, dim=-1))
        ctx = attend(q, k, v, causal=True, impl=cfg.attn_impl,
                     rope=True).reshape(b, s, d)
        return x + ctx @ self.wo.to(cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.attention_sublayer(x)
        h = _rmsnorm(x, self.ln2_scale)
        # jax.nn.gelu's default is the tanh approximation.
        up = F.gelu(h @ self.w_up.to(cfg.dtype), approximate="tanh")
        return x + up @ self.w_down.to(cfg.dtype)


class TransformerLM(nn.Module):
    """forward(tokens [B, S]) -> fp32 logits [B, S, vocab]."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        if cfg.remat != "none":
            raise NotImplementedError(
                f"remat={cfg.remat!r}: only 'none' is ported (ROADMAP "
                "queue 1, 'remat policies')")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.unembed = nn.Parameter(params["unembed"])
        self.blocks = nn.ModuleList(Block(cfg, bp) for bp in params["blocks"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed.to(cfg.dtype)[tokens]
        for block in self.blocks:
            x = block(x)
        x = _rmsnorm(x, torch.ones(cfg.d_model, device=x.device))
        return (x @ self.unembed.to(cfg.dtype)).float()


def loss_fn(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    # nll = logsumexp(logits) - logits[target]: the log_softmax + gather
    # math without a [B, S, V] fp32 log-prob array.
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - target_logit).mean()


def make_train_step(model: TransformerLM, lr: float = 1e-3):
    """SGD step on one device: step(tokens) -> loss (a 0-d tensor, not
    synchronized). Parameters are updated in place under no_grad — the
    counterpart of the reference donating its params buffer to XLA —
    so the fp32 masters are never copied."""
    params = list(model.parameters())

    def step(tokens: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model, tokens)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(g, alpha=lr)
        return loss.detach()

    return step
