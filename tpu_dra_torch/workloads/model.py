"""Transformer LM — the flagship workload, on one NVIDIA GPU or a
(data, model) mesh of them.

Counterpart of tpu_dra/workloads/model.py: the same model, parameter tree
and numerics, in PyTorch's idiom.

- Parameters are fp32 masters in JAX's [in, out] layout (``x @ W``), so
  carrying weights across from the reference is a copy, never a
  transpose (``params_from_jax``). The forward casts them to
  ``cfg.dtype`` (bf16 or fp32) on the matmul path.
- Attention is ``flashattention.attend(..., causal=True, rope=True)``:
  the hand-written CUDA kernels on a CUDA tensor, in bf16 or fp32. With
  ``cfg.seq_axis`` set, the forward runs on a sequence block and
  attention crosses blocks by all-to-all (``ulysses.ulysses_attention``).
- DP x TP (``build_train_step``): the reference lays ``param_specs`` over
  a ('data', 'model') mesh and XLA partitions the step. Here each rank
  holds its shard (``shard_params``) and the collectives are explicit,
  Megatron-style, over the mesh's 'model' group: ``wqkv`` and ``w_up``
  column-parallel (``wqkv``'s columns regrouped so each rank holds its
  own heads' q, k and v), ``wo`` and ``w_down`` row-parallel ending in an
  all-reduce, ``embed`` vocab-parallel (masked lookup, all-reduce) and
  ``unembed`` vocab-parallel with the loss as a vocab-parallel
  logsumexp. The batch splits over 'data' and the gradients are averaged
  there. On one device every collective is the identity, so the step is
  the single-device one.
- Rematerialization (``cfg.remat``): "full" recomputes each block in the
  backward (``torch.utils.checkpoint``), "dots" saves the matmul outputs
  only, as ``jax.checkpoint_policies.dots_saveable`` does (a selective
  checkpoint policy on ``aten.mm``/``addmm``/``bmm``). The kernels are
  launched through ctypes, which no dispatch mode sees: under either
  policy the attention forward runs again in the backward.
- The train step is plain SGD, updated in place.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from tpu_dra_torch.infra.trace import count, device_span
from tpu_dra_torch.workloads import _dist, _loss_kernels
from tpu_dra_torch.workloads.flashattention import attend

Params = Dict[str, Any]
REMAT_POLICIES = ("none", "dots", "full")


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
    # Context parallelism: when set, the forward runs on this rank's
    # sequence block of the mesh axis so named, and attention crosses
    # blocks by all-to-all (ulysses.ulysses_attention;
    # sp_train.make_sp_train_step is the driver). Empty = no SP.
    seq_axis: str = ""
    # Per-block rematerialization: "none" | "dots" | "full".
    remat: str = "none"
    # RMSNorm's epsilon (the reference's 1e-6; the DeepSeek-V3 family's
    # 1e-5).
    norm_eps: float = 1e-6

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
    return tree_map(lambda x: x.to(device), params)


def tree_map(fn, tree):
    """`fn` over every tensor (or array) leaf of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree: Params, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's parameter tree (tpu_dra.workloads.model.init_params,
    or moe_model's, leaves as numpy arrays) as this model's fp32 params
    on `device`. Both keep [in, out] weights, so each leaf is a copy."""
    device = resolve_device(device)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"{cfg.n_layers}")
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device),
        tree)


# ---------------------------------------------------------------------------
# DP x TP layout
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Params:
    """Per leaf, which dim shards over the 'model' axis (the reference's
    PartitionSpecs as tuples): TP shards the head/ff dims; the
    embeddings shard the vocab dim."""
    block = {
        "ln1_scale": (None,),
        "ln2_scale": (None,),
        "wqkv": (None, "model"),      # column-parallel QKV (per head)
        "wo": ("model", None),        # row-parallel output proj
        "w_up": (None, "model"),      # column-parallel up-proj
        "w_down": ("model", None),    # row-parallel down-proj
    }
    return {
        "embed": ("model", None),
        "unembed": (None, "model"),
        "blocks": [dict(block) for _ in range(cfg.n_layers)],
    }


def _spec_map(fn, specs, params, path=()):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, specs[k], params[k], path + (k,))
                for k in specs}
    if isinstance(specs, list):
        return [_spec_map(fn, s, p, path + (i,))
                for i, (s, p) in enumerate(zip(specs, params))]
    return fn(specs, params, path)


def _qkv_regroup(w: torch.Tensor, tp: int, inverse: bool = False):
    """wqkv's [D, 3D] columns (q | k | v, heads in order) regrouped so
    that a contiguous split into `tp` blocks gives each block its own
    heads' q, k and v: [q_0 k_0 v_0 | q_1 k_1 v_1 | ...]."""
    d = w.shape[0]
    cols = w.shape[1] // 3 // tp
    if inverse:
        return w.reshape(d, tp, 3, cols).transpose(1, 2).reshape(d, -1)
    return w.reshape(d, 3, tp, cols).transpose(1, 2).reshape(d, -1)


def _check_tp(cfg: ModelConfig, tp: int) -> None:
    for name, n in (("n_heads", cfg.n_heads), ("vocab", cfg.vocab),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            raise ValueError(f"{name}={n} does not divide by the 'model' "
                             f"axis' {tp} ranks")


def shard_params(params: Params, mesh, cfg: ModelConfig,
                 specs: Optional[Params] = None) -> Params:
    """This rank's shard of the full fp32 tree `params`: each leaf split
    on its 'model' dim (``specs``, default ``param_specs(cfg)``) and
    ``wqkv`` regrouped per head first. Leaves without a 'model' dim are
    the full leaf (replicated)."""
    _, tp, index = _dist.axis_of(mesh, "model")
    _check_tp(cfg, tp)

    def one(spec, leaf, path):
        if "model" not in spec or tp == 1:
            return leaf
        if path[-1] == "wqkv":
            leaf = _qkv_regroup(leaf, tp)
        return leaf.chunk(tp, dim=spec.index("model"))[index].contiguous()

    return _spec_map(one, specs or param_specs(cfg), params)


def unshard_params(shards: List[Params], cfg: ModelConfig,
                   specs: Optional[Params] = None) -> Params:
    """The full tree from the 'model' ranks' shards (in 'model' index
    order): the inverse of shard_params, wqkv's regrouping undone."""
    tp = len(shards)

    def one(spec, leaves, path):
        if "model" not in spec or tp == 1:
            return leaves[0]
        full = np.concatenate([np.asarray(x) for x in leaves],
                              axis=spec.index("model"))
        if path[-1] == "wqkv":
            full = _qkv_regroup(torch.from_numpy(full), tp,
                                inverse=True).numpy()
        return full

    def zipped(specs, trees):
        if isinstance(specs, dict):
            return {k: zipped(specs[k], [t[k] for t in trees]) for k in specs}
        if isinstance(specs, list):
            return [zipped(s, [t[i] for t in trees])
                    for i, s in enumerate(specs)]
        return trees

    return _spec_map(one, specs or param_specs(cfg), zipped(
        specs or param_specs(cfg), shards))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 variance, eps (the config's norm_eps), rounded to x.dtype
    before the scale — the reference's rounding points."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


# What "dots" saves: the matmul outputs (jax's dots_saveable).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_call(policy: str, fn, *args):
    """fn(*args) under the rematerialization `policy`."""
    if policy == "none":
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    raise ValueError(f"unknown remat policy {policy!r}")


class Block(nn.Module):
    """One pre-norm block; parameters named as the reference's tree,
    holding this rank's shards on a mesh."""

    def __init__(self, cfg: ModelConfig, leaves: Dict[str, Any], mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tp, self.tp_size, _ = _dist.axis_of(mesh, "model")
        for name, leaf in leaves.items():
            if isinstance(leaf, dict):
                continue
            self.register_parameter(name, nn.Parameter(leaf))

    def attention_sublayer(self, x: torch.Tensor) -> torch.Tensor:
        """pre-norm attention + residual; shared by the dense and MoE
        blocks."""
        cfg = self.cfg
        b, s, _ = x.shape
        heads = cfg.n_heads // self.tp_size
        width = heads * cfg.d_head
        h = _dist.copy_to(_rmsnorm(x, self.ln1_scale, cfg.norm_eps), self.tp)
        qkv = h @ self.wqkv.to(cfg.dtype)
        # Views of the fused projection: the kernels read them in place.
        q, k, v = (t.view(b, s, heads, cfg.d_head)
                   for t in qkv.split(width, dim=-1))
        if cfg.seq_axis:
            # x is this rank's sequence block; positions stay global
            # through the all-to-all, so the fused RoPE is exact.
            from tpu_dra_torch.workloads.ulysses import ulysses_attention

            ctx = ulysses_attention(
                q, k, v, group=self.mesh.group(cfg.seq_axis), causal=True,
                impl=cfg.attn_impl, rope=True)
        else:
            ctx = attend(q, k, v, causal=True, impl=cfg.attn_impl, rope=True)
        out = ctx.reshape(b, s, width) @ self.wo.to(cfg.dtype)
        return x + _dist.reduce_from(out, self.tp)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = _dist.copy_to(_rmsnorm(x, self.ln2_scale, cfg.norm_eps), self.tp)
        # jax.nn.gelu's default is the tanh approximation.
        up = F.gelu(h @ self.w_up.to(cfg.dtype), approximate="tanh")
        return x + _dist.reduce_from(up @ self.w_down.to(cfg.dtype), self.tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn(self.attention_sublayer(x))


class TransformerLM(nn.Module):
    """forward(tokens [B, S]) -> fp32 logits [B, S, vocab]; on a mesh
    with a 'model' axis, this rank's vocab shard of them. The loss takes
    ``head(trunk(tokens)[0])``, the logits in cfg.dtype.

    `params` is the full tree on one device, or this rank's shard
    (shard_params) on `mesh` (a _dist.Mesh)."""

    def __init__(self, cfg: ModelConfig, params: Params, mesh=None):
        super().__init__()
        if cfg.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {cfg.remat!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.tp, self.tp_size, self.tp_index = _dist.axis_of(mesh, "model")
        _check_tp(cfg, self.tp_size)
        self.embed = nn.Parameter(params["embed"])
        self.unembed = nn.Parameter(params["unembed"])
        self.blocks = nn.ModuleList(self.make_block(i, bp)
                                    for i, bp in enumerate(params["blocks"]))

    def make_block(self, i: int, leaves) -> nn.Module:
        return Block(self.cfg, leaves, self.mesh)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.embed.to(self.cfg.dtype)
        if self.tp_size == 1:
            return table[tokens]
        # Vocab-parallel: this rank's rows, zero for the others' tokens.
        rows = table.shape[0]
        local = tokens - self.tp_index * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
        return _dist.reduce_from(x, self.tp)

    def block_call(self, block: nn.Module, x: torch.Tensor):
        return remat_call(self.cfg.remat, block, x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of the blocks' output x, in cfg.dtype."""
        cfg = self.cfg
        x = _rmsnorm(x, torch.ones(cfg.d_model, device=x.device),
                     cfg.norm_eps)
        x = _dist.copy_to(x, self.tp)
        return x @ self.unembed.to(cfg.dtype)

    def trunk(self, tokens: torch.Tensor):
        """(the blocks' output [B, S, d_model], the auxiliary loss: None
        for the dense model)."""
        x = self.embed_tokens(tokens)
        for block in self.blocks:
            x = self.block_call(block, x)
        return x, None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(tokens)[0]).float()


class _FusedNLL(torch.autograd.Function):
    """nll [N] of logits [N, V] and targets [N] by the loss head's
    kernels (_loss_kernels: their plain versions on the CPU). Saves the
    logits as they came, lse and the targets: no fp32 [N, V] tensor."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse, nll = _loss_kernels.lse_nll(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        count("loss.fused_rows", logits.shape[0])
        return nll

    @staticmethod
    def backward(ctx, dnll):
        logits, targets, lse = ctx.saved_tensors
        return _loss_kernels.dlogits(logits, targets, lse, dnll), None


def token_nll(model: TransformerLM, logits: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Per-token nll = logsumexp(logits) - logits[target], fp32, of
    logits [..., V] in any float dtype. bf16 logits on a card with no
    'model' axis take the loss head's kernels (_FusedNLL), which read
    them in bf16 and write their gradient in bf16; any other logits are
    cast to fp32 and take logsumexp and a gather (the kernels' plain
    versions). On a 'model' axis the logits are this rank's vocab shard:
    the logsumexp is a max and a sum all-reduced, the target logit a
    masked gather all-reduced."""
    if model.tp_size == 1:
        if (logits.device.type == "cuda"
                and logits.dtype == _loss_kernels.KERNEL_DTYPE):
            nll = _FusedNLL.apply(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))
            return nll.view(targets.shape)
        return _loss_kernels.lse_nll_plain(logits, targets)[1]
    logits = logits.float()
    group = model.tp
    with torch.no_grad():
        peak = logits.amax(-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    sumexp = _dist.reduce_from(torch.exp(logits - peak[..., None]).sum(-1),
                               group)
    lse = torch.log(sumexp) + peak
    cols = logits.shape[-1]
    local = targets - model.tp_index * cols
    inside = (local >= 0) & (local < cols)
    picked = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    target_logit = _dist.reduce_from(picked * inside, group)
    return lse - target_logit


def lm_loss(model: TransformerLM, tokens: torch.Tensor):
    """(mean next-token nll over `tokens`' batch, the trunk's auxiliary
    loss) of any of the LM families: the head's logits in cfg.dtype go
    to token_nll as they are. Under torch.profiler the head and the loss
    are the range ``loss.head``."""
    x, aux = model.trunk(tokens[:, :-1])
    with device_span("loss.head"):
        logits = model.head(x)
        nll = token_nll(model, logits, tokens[:, 1:]).mean()
    return nll, aux


def loss_fn(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token nll over `tokens`' batch."""
    return lm_loss(model, tokens)[0]


def build_train_step(model: nn.Module, lr: float = 1e-3, loss=loss_fn):
    """SGD step over the model's mesh: step(tokens) -> loss (a 0-d
    tensor, not synchronized), `tokens` the GLOBAL batch [B, S].

    This rank trains on its 'data' block of the batch (B must divide by
    the axis: the reference's loss is the mean over the global batch,
    which the ranks' means average to only over equal blocks) with its
    parameter shards; gradients are averaged over 'data' in one
    all-reduce of the flattened gradients, and the returned loss is the
    global one. Parameters are updated in place under no_grad — the
    counterpart of the reference donating its params buffer to XLA — so
    the fp32 masters are never copied. On one device (or a mesh without
    a 'data' axis of size > 1) this is the single-device step.
    `loss(model, tokens)` is the objective.

    Under torch.profiler the step is the range ``step`` (its count the
    argument) around ``step.forward``, ``step.backward`` and
    ``step.sgd`` (infra.trace.device_span)."""
    params = list(model.parameters())
    group, n_data, index = _dist.axis_of(model.mesh, "data")
    counts = itertools.count()

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if n_data > 1:
            if tokens.shape[0] % n_data:
                raise ValueError(
                    f"batch {tokens.shape[0]} does not divide by the 'data' "
                    f"axis' {n_data} ranks")
            tokens = tokens.chunk(n_data)[index]
        with device_span("step", next(counts)):
            with device_span("step.forward"):
                value = loss(model, tokens)
            with device_span("step.backward"):
                grads = torch.autograd.grad(value, params)
            value = value.detach()
            if n_data > 1:
                flat = torch._utils._flatten_dense_tensors(grads)
                dist.all_reduce(flat, group=group)
                flat.div_(n_data)
                grads = torch._utils._unflatten_dense_tensors(flat, grads)
                value = value.clone()
                dist.all_reduce(value, group=group)
                value.div_(n_data)
            with device_span("step.sgd"), torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(g, alpha=lr)
        return value

    return step


def make_train_step(model: TransformerLM, lr: float = 1e-3):
    """SGD step of the dense model: step(tokens) -> loss (see
    build_train_step; on one device, the single-device step)."""
    return build_train_step(model, lr, loss_fn)


def param_tree(model: nn.Module, leaf=lambda p: p.data) -> Params:
    """The model's parameters as the reference's tree (this rank's
    shards on a mesh), each leaf `leaf(parameter)`: by default the
    parameter's own tensor, which a model built on it shares."""
    blocks = []
    for block in model.blocks:
        tree: Params = {}
        for name, p in block.named_parameters():
            *outer, last = name.split(".")
            node = tree
            for key in outer:
                node = node.setdefault(key, {})
            node[last] = leaf(p)
        blocks.append(tree)
    return {"embed": leaf(model.embed), "unembed": leaf(model.unembed),
            "blocks": blocks}


def local_params(model: nn.Module) -> Params:
    """This rank's parameter tree (its shards) as fp32 numpy arrays."""
    return param_tree(model, lambda p: p.detach().float().cpu().numpy())
