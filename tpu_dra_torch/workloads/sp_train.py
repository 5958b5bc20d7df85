"""Context-parallel (sequence-sharded) training step (counterpart of
tpu_dra/workloads/sp_train.py).

The third layout for the dense model, beside the DP x TP step
(model.build_train_step) and the pipeline: activations shard on the
SEQUENCE axis, parameters are replicated, and only attention crosses
shards (the all-to-alls of ulysses_attention inside the forward,
ModelConfig.seq_axis).

Objective: next-token prediction over the FULL sequence via a global
roll — targets[i] = tokens[i + 1], the final position masked — as the
reference computes it. Each rank's forward returns its shard's sum of
nll, and the global loss is the shards' sums over the global count,
reduced outside the forward: each rank differentiates its own sum over
the global count (the all-to-alls' backward carries the other ranks'
cotangents into its activations), and the gradients are all-reduced
(summed) over the axis. The reference's note (sp_train.py:50-66) on a
psum of gradients inside the shard body does not apply: here the
collective on the gradients is outside the differentiated function.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads.model import param_tree, token_nll


def make_sp_train_step(model, mesh, lr: float = 1e-3,
                       axis_name: str = "seq"):
    """SGD step over sequence-sharded tokens: step(tokens) -> loss, with
    `tokens` the GLOBAL [B, S] batch (S divisible by the axis size, and
    the heads too: the ulysses constraint). `model` holds the full
    (replicated) parameters; the step trains a model over the same
    parameter tensors with cfg.seq_axis set, so `model` sees the update.
    Returns the global loss."""
    cfg = dataclasses.replace(model.cfg, seq_axis=axis_name)
    sp_model = type(model)(cfg, param_tree(model), mesh)
    params = list(sp_model.parameters())
    group, n, _ = _dist.axis_of(mesh, axis_name)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        # Global next-token objective: roll the sequence left by one and
        # mask the final position (its "target" wrapped around).
        targets = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
        count = mask.sum().clamp_min(1.0)
        tok, tgt, msk = (_dist.shard(x, mesh, axis_name, 1)
                         for x in (tokens, targets, mask))
        logits = sp_model(tok)
        local = (token_nll(sp_model, logits, tgt) * msk).sum()
        grads = torch.autograd.grad(local / count, params)
        value = local.detach().clone()
        if n > 1:
            flat = torch._utils._flatten_dense_tensors(grads)
            dist.all_reduce(flat, group=group)
            grads = torch._utils._unflatten_dense_tensors(flat, grads)
            dist.all_reduce(value, group=group)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(g.to(p.dtype), alpha=lr)
        return value / count

    return step
