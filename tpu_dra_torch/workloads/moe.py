"""Expert-parallel MoE feed-forward (counterpart of
tpu_dra/workloads/moe.py).

Top-1 token-choice routing (Switch style) with dense one-hot dispatch and
combine tensors, as the reference computes it: routing in fp32, each
token's position within its expert's capacity in (b, s) order (a cumsum
over the flattened batch), overflow dropped, and a load-balancing aux
loss. Expert parallelism shards the experts' leading dim over an axis:
each rank holds its local experts and the FULL (replicated) activations,
computes its experts' slice of the dense dispatch, and one all-reduce
combines (the dispatch masks zero every foreign expert's term).

Under data parallelism (the MoE LM's 'data' axis) routing stays global,
as the reference's step computes it over the global batch: the capacity
counts the global batch, positions continue from the lower data ranks'
counts (their blocks come first in (b, s) order), and the aux loss's
means are over the global batch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_dra_torch.infra import trace
from tpu_dra_torch.workloads import _dist


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """router [D, E] fp32, w_up [E, D, F] and w_down [E, F, D] in
    `dtype`, drawn from `generator` on its own device (the reference's
    scales; not its draws — params_from_jax carries those)."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    out = {
        "router": normal((d_model, n_experts), 1.0 / math.sqrt(d_model)),
        "w_up": normal((n_experts, d_model, d_ff),
                       1.0 / math.sqrt(d_model)).to(dtype),
        "w_down": normal((n_experts, d_ff, d_model),
                         1.0 / math.sqrt(d_ff)).to(dtype),
    }
    return {k: v.to(device or generator.device) for k, v in out.items()}


def capacity_of(capacity_factor: float, tokens: int, n_experts: int) -> int:
    """Per-expert capacity, in Python as the reference computes it."""
    return max(1, int(capacity_factor * tokens / n_experts))


def route_top1(x: torch.Tensor, router_w: torch.Tensor, n_experts: int,
               capacity: int, data_group=None):
    """(dispatch [B,S,E,C], combine [B,S,E,C], aux_loss) for x [B,S,D].

    Position c of expert e holds token (b, s) iff the token routed to e
    within capacity. Router math in fp32. With `data_group`, x is this
    rank's block of a batch split over that group in rank order, and the
    positions and the aux loss are those of the whole batch.

    Under torch.profiler the call is the range ``moe.route`` and counts
    ``moe.kept`` (this rank's tokens kept within capacity),
    ``moe.slots`` (E x C) and ``moe.routed`` (this rank's B x S)."""
    with trace.device_span("moe.route"):
        logits = x.float() @ router_w.float()                  # [B,S,E]
        probs = torch.softmax(logits, dim=-1)
        expert = probs.argmax(-1)     # the first maximum, as jnp.argmax
        onehot = F.one_hot(expert, n_experts).float()
        flat = onehot.reshape(-1, n_experts)
        counts = flat.sum(0)
        offset = torch.zeros_like(counts)
        n_data = _dist.group_size(data_group)
        if n_data > 1:
            every = [torch.empty_like(counts) for _ in range(n_data)]
            dist.all_gather(every, counts, group=data_group)
            offset = sum(every[:_dist.group_rank(data_group)], offset)
            counts = sum(every[1:], every[0])
        # Position within the expert's capacity, in (b, s) order.
        pos = (torch.cumsum(flat, dim=0) + offset) * flat - 1.0
        pos = pos.reshape(onehot.shape)                        # [B,S,E]
        keep = (pos >= 0) & (pos < capacity)
        if trace.recording():
            trace.count("moe.kept", keep.sum())
            trace.count("moe.slots", n_experts * capacity)
            trace.count("moe.routed", flat.shape[0])
        pos_cap = pos.clamp(0, capacity - 1).long()
        dispatch = (F.one_hot(pos_cap, capacity).float()
                    * (onehot * keep)[..., None])              # [B,S,E,C]
        gate = (probs * onehot).amax(-1)                       # [B,S]
        combine = dispatch * gate[..., None, None]
        # Load-balancing aux loss (mean prob x mean assignment per
        # expert), the means over the whole batch.
        n_tokens = flat.shape[0] * n_data
        density = counts / n_tokens
        density_proxy = (_dist.all_reduce(probs.sum((0, 1)), data_group)
                         / n_tokens)
        aux = (density * density_proxy).sum() * (n_experts ** 2)
        return dispatch, combine, aux


def _experts(params, x, dispatch, combine, compute_dtype):
    """The ranges ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
    under torch.profiler, each with its operands' casts."""
    cd = compute_dtype
    # Dispatch tokens to expert buffers: [E, C, D].
    with trace.device_span("moe.dispatch"):
        buffers = torch.einsum("bsec,bsd->ecd", dispatch.to(cd), x.to(cd))
    with trace.device_span("moe.experts"):
        h = F.gelu(torch.einsum("ecd,edf->ecf", buffers,
                                params["w_up"].to(cd)), approximate="tanh")
        out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cd))
    with trace.device_span("moe.combine"):
        return torch.einsum("bsec,ecd->bsd", combine.to(cd), out_buf)


def moe_ffn(params: Dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
            compute_dtype=torch.float32):
    """Unsharded MoE FFN: x [B,S,D] -> ([B,S,D], aux). Routing stays
    fp32 (route_top1); the expert matmuls run in `compute_dtype` — bf16
    from the MoE transformer, fp32 by default."""
    n_experts = params["router"].shape[-1]
    b, s, _ = x.shape
    capacity = capacity_of(capacity_factor, b * s, n_experts)
    dispatch, combine, aux = route_top1(x, params["router"], n_experts,
                                        capacity)
    out = _experts(params, x, dispatch, combine, compute_dtype)
    return out.to(x.dtype), aux


def expert_parallel_ffn(params: Dict, x: torch.Tensor, *, group,
                        capacity_factor: float = 1.25,
                        compute_dtype=torch.float32, data_group=None):
    """This rank's body: `params` holds its local experts (w_up, w_down
    [E/N, ...]) and the full router; x [B,S,D] is the same on every rank
    of `group`. Routes over all experts, computes the local experts'
    slice of the dense dispatch and combines with one all-reduce.
    Differentiable: routing runs outside the parallel region, so the
    router and x get the same gradient on every rank."""
    n_local = params["w_up"].shape[0]
    n_experts = n_local * _dist.group_size(group)
    b, s, _ = x.shape
    capacity = capacity_of(capacity_factor,
                           b * s * _dist.group_size(data_group), n_experts)
    dispatch, combine, aux = route_top1(x, params["router"], n_experts,
                                        capacity, data_group)
    # Slice MY experts out of the dense dispatch/combine tensors.
    mine = slice(_dist.group_rank(group) * n_local,
                 (_dist.group_rank(group) + 1) * n_local)
    x_in = _dist.copy_to(x, group)
    cb = _dist.copy_to(combine, group)[:, :, mine]
    out = _experts(params, x_in, dispatch[:, :, mine], cb, compute_dtype)
    return _dist.reduce_from(out, group).to(x.dtype), aux


def make_expert_parallel_ffn(mesh, axis_name: str = "expert",
                             capacity_factor: float = 1.25):
    """Expert-parallel MoE FFN over `mesh`'s expert axis: fn(params, x)
    -> (out, aux) with `params` this rank's shard (shard_moe_params) and
    x replicated; fp32 expert matmuls, as the reference's."""
    group = mesh.group(axis_name)

    def fn(params, x):
        return expert_parallel_ffn(params, x, group=group,
                                   capacity_factor=capacity_factor)

    return fn


def shard_moe_params(params: Dict, mesh, axis_name: str = "expert") -> Dict:
    """This rank's experts (the leading dim split over the axis) and the
    replicated router."""
    return {"router": params["router"],
            **{k: _dist.shard(params[k], mesh, axis_name, 0).contiguous()
               for k in ("w_up", "w_down")}}

