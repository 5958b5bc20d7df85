"""Pipeline parallelism: a GPipe microbatch schedule over a 'stage' axis
(counterpart of tpu_dra/workloads/pipeline.py).

With S stages and M microbatches, at tick t stage s works on microbatch
t - s when 0 <= t - s < M (the bubble is the GPipe (S - 1) / (M + S - 1)
share). Each tick, every stage sends its output to the next stage and
receives the previous stage's (a send/recv pair between neighbours);
each rank holds only its own stage's weights. The last stage collects
the finished microbatches and broadcasts them at the end, where the
reference sums the stages' accumulators with psum (every other
accumulator is zero there).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_dra_torch.workloads import _dist


def init_stage_params(generator: torch.Generator, n_stages: int,
                      d_model: int, dtype=torch.float32) -> torch.Tensor:
    """One square gelu-MLP block per stage: [S, D, D]."""
    w = torch.randn((n_stages, d_model, d_model), generator=generator,
                    device=generator.device)
    return (w / math.sqrt(d_model)).to(dtype)


def stage_fn(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The per-stage block; swap for any (w, x) -> y computation."""
    return F.gelu(x @ w, approximate="tanh")


def pipeline_reference(weights: torch.Tensor, microbatches: torch.Tensor,
                       fn: Callable = stage_fn) -> torch.Tensor:
    """Sequential ground truth: every stage over every microbatch."""
    out = microbatches
    for s in range(weights.shape[0]):
        out = fn(weights[s], out)
    return out


def _exchange(y: torch.Tensor, group, stage: int, n_stages: int,
              zero: torch.Tensor) -> torch.Tensor:
    """Stage s's output to stage s + 1; returns what stage s - 1 sent
    (zeros on stage 0, which reads the microbatches instead)."""
    ops = []
    recv = zero
    if stage + 1 < n_stages:
        ops.append(dist.P2POp(dist.isend, y.contiguous(),
                              dist.get_global_rank(group, stage + 1), group))
    if stage > 0:
        recv = torch.empty_like(zero)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, stage - 1), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def make_pipeline_forward(mesh, axis_name: str = "stage",
                          fn: Callable = stage_fn):
    """Pipeline-parallel forward over `mesh`'s stage axis:
    fwd(w, microbatches) with `w` this stage's block [D, D] (or its
    [1, D, D] shard) and microbatches [M, B, D] on every rank -> the
    [M, B, D] outputs, the same on every rank (produced on the last stage
    and broadcast)."""
    group, n_stages, stage = _dist.axis_of(mesh, axis_name)

    @torch.no_grad()
    def fwd(w: torch.Tensor, mbs: torch.Tensor) -> torch.Tensor:
        if w.dim() == 3:
            w = w[0]
        m = mbs.shape[0]
        zero = torch.zeros_like(mbs[0])
        outs = torch.zeros_like(mbs)
        recv = zero
        for t in range(m + n_stages - 1):
            active = 0 <= t - stage < m
            x_in = mbs[min(t, m - 1)] if stage == 0 else recv
            y = fn(w, x_in) if active else zero
            if stage == n_stages - 1 and active:
                outs[t - stage] = y
            if n_stages > 1:
                recv = _exchange(y, group, stage, n_stages, zero)
        if n_stages > 1:
            dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1),
                           group=group)
        return outs

    return fwd


def shard_stage_params(weights: torch.Tensor, mesh,
                       axis_name: str = "stage") -> torch.Tensor:
    """This rank's stage block, [1, D, D]."""
    return _dist.shard(weights, mesh, axis_name, 0).contiguous()
