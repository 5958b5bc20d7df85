"""Expert-parallel MoE feed-forward (counterpart of
tpu_dra/workloads/moe.py).

Top-1 token-choice routing (Switch style), as the reference computes it:
routing in fp32, each token's position within its expert's capacity in
(b, s) order, overflow dropped, and a load-balancing aux loss. Where the
reference builds dense one-hot [B,S,E,C] dispatch and combine tensors
(static shapes under jit), the port routes by slot index: each kept token
gets the slot e·C + c of an [E·C, D] expert buffer and each slot its
token, so dispatch and combine, and their backward, are row gathers of a
fixed shape: the top-k layer's _Dispatch and _Combine at k = 1, the slots
as rows (_moe_kernels: hand-written CUDA kernels on the card, their
plain versions on the CPU). The values are the dense einsums', whose one
non-zero term per output is rounded once.

Expert parallelism shards the experts' leading dim over an axis: each
rank holds its local experts and the FULL (replicated) activations,
routes over all experts, fills only its experts' slots (a foreign
token's combine row is zero) and one all-reduce combines.

The DeepSeek-V3 family's layer (``topk_ffn``, dsv3_model.py) routes each
token to its top-k of many fine-grained experts by sigmoid scores with a
selection bias, and drops nothing: every (token, k) pair whose expert is
held gets a row of an [N, D] buffer, the held experts' rows one after
another (``route_topk``), one grouped GEMM per projection runs them, a
k-way gate-weighted combine sums them back, and a shared expert sees
every token. The layer is told the experts it holds (``experts``, a
range of the router's), as expert parallelism would give them, with no
process group: what the absent experts add is left out.

Under data parallelism (the MoE LM's 'data' axis) routing stays global,
as the reference's step computes it over the global batch: the capacity
counts the global batch, positions continue from the lower data ranks'
counts (their blocks come first in (b, s) order), and the aux loss's
means are over the global batch.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_dra_torch.infra import trace
from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import _moe_kernels as mk


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


class Route(NamedTuple):
    """route_top1's result for x [B,S,D] over this rank's experts."""
    slot: torch.Tensor            # [B,S] int32: (e - lo)·C + c, or -1
    token_of_slot: torch.Tensor   # [E_local·C] int32: b·S + s, or -1
    gate: torch.Tensor            # [B,S] fp32: the routed expert's prob
    aux: torch.Tensor             # the load-balancing loss


def route_top1(x: torch.Tensor, router_w: torch.Tensor, n_experts: int,
               capacity: int, data_group=None,
               experts: Optional[range] = None) -> Route:
    """Route x [B,S,D] to its top-1 experts by slot index.

    Token (b, s) routed to expert e at position c < `capacity` within it
    holds slot (e - lo)·C + c of this rank's buffer when e is one of
    `experts` (range(lo, hi); all by default), else its slot is -1, as
    is a dropped token's. Router math in fp32. With `data_group`, x is
    this rank's block of a batch split over that group in rank order,
    and the positions and the aux loss are those of the whole batch.

    Under torch.profiler the call is the range ``moe.route`` and counts
    ``moe.kept`` (this rank's tokens kept within capacity, by any
    expert), ``moe.slots`` (E x C) and ``moe.routed`` (this rank's
    B x S)."""
    experts = experts or range(n_experts)
    with trace.device_span("moe.route"):
        logits = x.float() @ router_w.float()                  # [B,S,E]
        probs = torch.softmax(logits, dim=-1)
        expert = probs.argmax(-1)     # the first maximum, as jnp.argmax
        gate = probs.gather(-1, expert[..., None])[..., 0]     # [B,S]
        flat = expert.reshape(-1).int()
        offset = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
        counts = None
        n_data = _dist.group_size(data_group)
        if n_data > 1:
            local = offset.index_add(0, flat, torch.ones_like(flat))
            every = [torch.empty_like(local) for _ in range(n_data)]
            dist.all_gather(every, local, group=data_group)
            offset = sum(every[:_dist.group_rank(data_group)], offset)
            counts = sum(every[1:], every[0])
        # Position within the expert's capacity, in (b, s) order.
        _, slot, token_of_slot, routed, kept = mk.route(
            flat, offset, capacity, experts.start, experts.stop)
        counts = routed if counts is None else counts
        if trace.recording():
            trace.count("moe.kept", kept[0])
            trace.count("moe.slots", n_experts * capacity)
            trace.count("moe.routed", flat.numel())
        # Load-balancing aux loss (mean prob x mean assignment per
        # expert), the means over the whole batch.
        n_tokens = flat.numel() * n_data
        density = counts.float() / n_tokens
        density_proxy = (_dist.all_reduce(probs.sum((0, 1)), data_group)
                         / n_tokens)
        aux = (density * density_proxy).sum() * (n_experts ** 2)
        return Route(slot.view(expert.shape), token_of_slot, gate, aux)


class _Dispatch(torch.autograd.Function):
    """buf [N, D] of x [T, D]: row r holds x[token_of_row[r]] (zeros where
    it is -1); dx[t] is the sum of dbuf over the token's k rows slot[t·k
    + j] that are not -1, in fp32 and rounded once. Both routings: top-1
    at k = 1 with its slots as rows, top-k over the held pairs' rows."""

    @staticmethod
    def forward(ctx, x, token_of_row, slot, k):
        ctx.save_for_backward(slot)
        ctx.k = k
        return mk.gather_rows(x, token_of_row)

    @staticmethod
    def backward(ctx, dbuf):
        with trace.device_span("moe.dispatch"):
            slot, = ctx.saved_tensors
            return mk.combine_rows(dbuf, slot, None, ctx.k), None, None, None


class _Combine(torch.autograd.Function):
    """out [T, D] of y [N, D]: out[t] = sum_j scale[t·k + j] · y[slot[t·k
    + j]] over the j with slot >= 0, in fp32 and rounded once. `scale`
    [T·k] and gate_of_row [N] (fp32, no gradient) are the gates' values
    as the layer multiplies by them (top-1: rounded to y's dtype, by pair
    and by row); dy[r] = gate_of_row[r] · dout[token_of_row[r]], and the
    gradient of `gates` [T·k] fp32 is dout[p // k] · y[slot[p]] in
    fp32, unrounded."""

    @staticmethod
    def forward(ctx, y, gates, scale, slot, token_of_row, gate_of_row, k):
        ctx.save_for_backward(y, slot, token_of_row, gate_of_row)
        ctx.k = k
        return mk.combine_rows(y, slot, scale, k)

    @staticmethod
    def backward(ctx, dout):
        with trace.device_span("moe.combine"):
            y, slot, token_of_row, gate_of_row = ctx.saved_tensors
            dout = dout.to(y.dtype)
            d_y = d_gates = None
            if ctx.needs_input_grad[0]:
                d_y = mk.gather_rows(dout, token_of_row, gate_of_row)
            if ctx.needs_input_grad[1]:
                d_gates = mk.pair_dot(dout, y, slot, ctx.k)
            return d_y, d_gates, None, None, None, None, None


def top1_scales(gate, token_of_slot, dtype):
    """(scale [T], gate_of_slot [E_local·C]) fp32, no gradient: the
    top-1 combine's factors, each token's gate rounded to `dtype` as the
    reference's combine tensor holds it, and each slot's token's (0
    where the slot is empty)."""
    scale = gate.detach().reshape(-1).to(dtype).float()
    # The -1 of an empty slot reads the pad's 0.
    return scale, F.pad(scale, (0, 1))[token_of_slot.long()]


def _experts(params, x, slot, token_of_slot, gate, compute_dtype):
    """The ranges ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
    under torch.profiler (dispatch and combine also in their backward),
    each with its operands' casts. x [B,S,D] -> [B,S,D] in
    `compute_dtype`; this rank's experts fill the slots of `slot` and
    `token_of_slot`."""
    cd = compute_dtype
    b, s, d = x.shape
    n_local = params["w_up"].shape[0]
    # Dispatch tokens to expert buffers: [E, C, D].
    slot = slot.reshape(-1)
    with trace.device_span("moe.dispatch"):
        buffers = _Dispatch.apply(x.to(cd).reshape(b * s, d), token_of_slot,
                                  slot, 1)
        buffers = buffers.view(n_local, -1, d)
    with trace.device_span("moe.experts"):
        h = F.gelu(torch.einsum("ecd,edf->ecf", buffers,
                                params["w_up"].to(cd)), approximate="tanh")
        out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cd))
    with trace.device_span("moe.combine"):
        # Scaled by the rounded gate; the gradient reaches the fp32 gate.
        scale, gate_of_slot = top1_scales(gate, token_of_slot, cd)
        out = _Combine.apply(out_buf.reshape(-1, d), gate.reshape(-1), scale,
                             slot, token_of_slot, gate_of_slot, 1)
        return out.view(b, s, d)


def moe_ffn(params: Dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
            compute_dtype=torch.float32):
    """Unsharded MoE FFN: x [B,S,D] -> ([B,S,D], aux). Routing stays
    fp32 (route_top1); the expert matmuls run in `compute_dtype` — bf16
    from the MoE transformer, fp32 by default."""
    n_experts = params["router"].shape[-1]
    b, s, _ = x.shape
    capacity = capacity_of(capacity_factor, b * s, n_experts)
    route = route_top1(x, params["router"], n_experts, capacity)
    out = _experts(params, x, route.slot, route.token_of_slot, route.gate,
                   compute_dtype)
    return out.to(x.dtype), route.aux


def expert_parallel_ffn(params: Dict, x: torch.Tensor, *, group,
                        capacity_factor: float = 1.25,
                        compute_dtype=torch.float32, data_group=None):
    """This rank's body: `params` holds its local experts (w_up, w_down
    [E/N, ...]) and the full router; x [B,S,D] is the same on every rank
    of `group`. Routes over all experts, fills its local experts' slots
    and combines with one all-reduce. Differentiable: routing runs
    outside the parallel region, so the router and x get the same
    gradient on every rank."""
    n_local = params["w_up"].shape[0]
    n_experts = n_local * _dist.group_size(group)
    b, s, _ = x.shape
    capacity = capacity_of(capacity_factor,
                           b * s * _dist.group_size(data_group), n_experts)
    first = _dist.group_rank(group) * n_local
    route = route_top1(x, params["router"], n_experts, capacity, data_group,
                       experts=range(first, first + n_local))
    x_in = _dist.copy_to(x, group)
    gate = _dist.copy_to(route.gate, group)
    out = _experts(params, x_in, route.slot, route.token_of_slot, gate,
                   compute_dtype)
    return _dist.reduce_from(out, group).to(x.dtype), route.aux


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



# ---------------------------------------------------------------------------
# Top-k, dropless, over the held experts (the DeepSeek-V3 family)
# ---------------------------------------------------------------------------

class RouteK(NamedTuple):
    """route_topk's result for h [B,S,D] over the held experts."""
    slot: torch.Tensor          # [B·S·K] int32: the pair's row, or -1
    token_of_row: torch.Tensor  # [N] int32: the token of each row
    gate_of_row: torch.Tensor   # [N] fp32: the gate of each row's pair
    gates: torch.Tensor         # [B·S·K] fp32: g_i of every pair
    ends: torch.Tensor          # [E_held] int32: each expert's row end
    rows: list                  # [E_held + 1] host ints: the row offsets
    aux: torch.Tensor           # the sequence-wise balance loss


def route_topk(h: torch.Tensor, router_w: torch.Tensor,
               bias: torch.Tensor, top_k: int, experts: range,
               scale: float) -> RouteK:
    """Route h [B,S,D] to each token's top-k experts, dropping none.

    Scores s = sigmoid(h W_r) in fp32 over all E experts; the selected
    experts are the top k of s + bias (the bias only selects); the gates
    are scale · s_i / sum of the k selected s. Each (token, k) pair whose
    expert lies in `experts` gets a row of the held experts' buffer
    (_moe_kernels.route_topk), the rest none. The sequence-wise balance
    loss (DeepSeek-V3, arXiv:2412.19437 eq. 17-20) is, per sequence of T
    positions, sum_i f_i P_i with f_i = E / (k T) · #{t: i selected at t}
    and P_i the mean over t of s_i / sum_j s_j, averaged over sequences.

    The layer synchronises with the host once here: the held experts' row
    offsets (E_held + 1 ints) size the buffer and the grouped GEMMs.
    Under torch.profiler the call is the range ``moe.route`` and counts
    ``moe.assigned`` (held pairs), ``moe.load_max`` (the largest held
    expert's rows) and ``moe.tokens_held`` (tokens with a held pair) on
    the device, and ``moe.routed`` (B x S),
    ``moe.held`` (the experts held) and ``moe.selected`` (B x S x k) on
    the host."""
    b, s, _ = h.shape
    n_experts = router_w.shape[-1]
    with trace.device_span("moe.route"):
        scores = torch.sigmoid(h.float() @ router_w.float())        # [B,S,E]
        with torch.no_grad():
            chosen = torch.topk(scores + bias.float(), top_k, dim=-1).indices
        picked = scores.gather(-1, chosen)
        gates = (scale * picked / picked.sum(-1, keepdim=True)).reshape(-1)
        slot, pair_of_row, token_of_row, offsets, stats = mk.route_topk(
            chosen, top_k, experts.start, experts.stop)
        rows = offsets.tolist()
        n_rows = rows[-1]
        pair_of_row = pair_of_row[:n_rows]
        if trace.recording():
            trace.count("moe.assigned", stats[0])
            trace.count("moe.load_max", stats[1])
            trace.count("moe.tokens_held",
                        slot.view(-1, top_k).ge(0).any(1).sum())
            trace.count("moe.routed", b * s)
            trace.count("moe.held", len(experts))
            trace.count("moe.selected", b * s * top_k)
        with torch.no_grad():
            share = torch.zeros(b, n_experts, device=h.device).scatter_add_(
                1, chosen.reshape(b, -1),
                torch.ones(b, s * top_k, device=h.device))
            share = share * (n_experts / (top_k * s))
        prob = (scores / scores.sum(-1, keepdim=True)).mean(1)      # [B,E]
        aux = (share * prob).sum(-1).mean()
        return RouteK(slot, token_of_row[:n_rows],
                      gates.detach()[pair_of_row.long()], gates,
                      offsets[1:], rows, aux)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
               rows: list) -> torch.Tensor:
    """[N, out] of x [N, in] and w [G, in, out]: rows [rows[g],
    rows[g + 1]) of x times w[g], one grouped GEMM (torch._grouped_mm,
    with `ends` the groups' row ends on the device) on a card, a loop of
    plain products on the CPU."""
    if x.device.type == "cuda":
        return torch._grouped_mm(x, w, offs=ends)
    return torch.cat([x[a:b] @ w[g] for g, (a, b)
                      in enumerate(zip(rows[:-1], rows[1:]))]
                     + [x.new_zeros(0, w.shape[-1])])


def swiglu(x: torch.Tensor, w_gate_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x W_g) · x W_u) W_d with W_gate_up = [W_g | W_u], [in, 2F]."""
    gate, up = (x @ w_gate_up).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w_down


def topk_ffn(params: Dict, h: torch.Tensor, *, top_k: int, experts: range,
             scale: float, compute_dtype=torch.bfloat16):
    """The DeepSeek-V3 MoE FFN on the normed h [B,S,D] over the held
    `experts`: (shared(h) + sum over the held selected experts of g_i ·
    E_i(h), the balance loss), in `compute_dtype` with the router in
    fp32. `params`: router [D, E] and bias [E] (fp32), the held experts'
    w_gate, w_up [E_held, D, F] and w_down [E_held, F, D], and the shared
    expert's shared_gate, shared_up [D, F_s] and shared_down [F_s, D]; a
    layer with no shared expert (MiMo-V2-Flash's) has none of the three,
    and its output is the routed sum alone.

    Ranges under torch.profiler: ``moe.route``, ``moe.dispatch`` (tokens
    gathered into their rows; again in the backward), ``moe.experts``
    (two grouped GEMMs and the SwiGLU), ``moe.combine`` (the k-way
    gate-weighted sum; again in the backward) and ``moe.shared`` (where
    the layer has a shared expert); the counter ``moe.row_bytes`` is the
    bytes of one token's row."""
    cd = compute_dtype
    b, s, d = h.shape
    route = route_topk(h, params["router"], params["bias"], top_k, experts,
                       scale)
    x = h.to(cd).reshape(b * s, d)
    trace.count("moe.row_bytes", d * x.element_size())
    with trace.device_span("moe.dispatch"):
        buf = _Dispatch.apply(x, route.token_of_row, route.slot, top_k)
    with trace.device_span("moe.experts"):
        w_in = torch.cat([params["w_gate"], params["w_up"]], -1).to(cd)
        gate, up = grouped_mm(buf, w_in, route.ends, route.rows).chunk(2, -1)
        y = grouped_mm(F.silu(gate) * up, params["w_down"].to(cd),
                       route.ends, route.rows)
    with trace.device_span("moe.combine"):
        routed = _Combine.apply(y, route.gates, route.gates.detach(),
                                route.slot, route.token_of_row,
                                route.gate_of_row, top_k)
    if "shared_gate" not in params:
        return routed.view(b, s, d), route.aux
    with trace.device_span("moe.shared"):
        shared = swiglu(x, torch.cat([params["shared_gate"],
                                      params["shared_up"]], -1).to(cd),
                        params["shared_down"].to(cd))
    return (routed + shared).view(b, s, d), route.aux
