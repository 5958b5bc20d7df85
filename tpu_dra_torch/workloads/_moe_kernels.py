"""Launch the MoE FFN's routing and row-copy kernels (csrc/moe_route.cu).

Five wrappers, one per C entry point, each with its plain PyTorch
version beside it. The top-1 route (moe.route_top1):

- ``route`` (``moe_route``): each token's position within its expert in
  token order, continued from ``offset`` (the lower data ranks' counts),
  its slot (e - lo) * C + c in this rank's expert buffer where expert e
  lies in [lo, hi) and c < C (else -1), the token of each slot (-1 where
  empty), the tokens routed to each expert and the tokens kept within
  capacity by any expert. One CTA scans the tokens.

The top-k dropless route over a rank's held experts (moe.route_topk):

- ``route_topk`` (``moe_route_topk``): each (token, k) pair's row in the
  held experts' [N, D] buffer (pairs in (b, s, k) order, each expert's
  rows in that order, experts one after another), the pair and the token
  of each row, the experts' row offsets and (N, the largest expert's
  rows). One CTA scans the pairs.

The row copies, which both routings' dispatch and combine run (the
top-1 route's at k = 1, its slots as rows):

- ``gather_rows`` (``moe_gather_rows``): dst[i] = scale[i] * src[idx[i]],
  or zeros where idx[i] < 0; without scale a copy. The product is taken
  in fp32 and rounded once to the rows' dtype.
- ``combine_rows`` (``moe_combine_rows``): out[t] = sum_k gate[t, k] *
  src[idx[t, k]] over the held pairs (the plain sum without gates), in
  fp32, rounded once.
- ``pair_dot`` (``moe_pair_dot``): out[p] = sum_d a[p // k, d] * b[idx[p],
  d] in fp32, or 0 where idx[p] < 0.

The source's header says what bounds the kernels on the H100 and what
their design does about it; they replace no TPU kernel (the reference's
dense one-hot einsums). _cuda.py builds, loads and launches them; this
module declares the source's entry points there. For CPU tensors each
wrapper runs its plain version; for CUDA tensors it launches its kernel
on the current stream (_cuda.launch, which counts it under the entry's
name). There is no other path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads import _cuda

# What the row kernels take, and the element size each is told. Rows are
# moved in 16-byte vectors, so D must be a multiple of ROW_MULTIPLE.
ROW_DTYPES = {torch.bfloat16: 2, torch.float32: 4}
ROW_MULTIPLE = 8

_PTR, _INT = _cuda.PTR, _cuda.INT
# The C entry points of csrc/moe_route.cu; each takes the stream last.
ARGTYPES = {
    # expert, offset, pos, slot, token_of_slot, counts, kept; T, E, C,
    # the rank's experts [e_lo, e_hi).
    "moe_route": [_PTR] * 7 + [_INT] * 5 + [_PTR],
    # src, idx, scale, dst; rows, D, element bytes.
    "moe_gather_rows": [_PTR] * 4 + [_INT] * 3 + [_PTR],
    # expert, slot, pair_of_row, token_of_row, offsets, stats; pairs, k,
    # the rank's experts [e_lo, e_hi).
    "moe_route_topk": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    # src, idx, gate, dst; rows, k, D, element bytes.
    "moe_combine_rows": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # a, b, idx, out; pairs, k, D, element bytes.
    "moe_pair_dot": [_PTR] * 4 + [_INT] * 4 + [_PTR],
}
# The most experts one route_topk call holds (csrc/moe_route.cu kMaxHeld).
MAX_HELD = 16
_cuda.declare({"moe_route": ARGTYPES})


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def route_plain(expert, offset, capacity: int, lo: int, hi: int):
    """route's function: a cumsum of the one-hot along its inner (token)
    dimension."""
    n_experts = offset.numel()
    e = expert.long()
    onehot = F.one_hot(e, n_experts).T                      # [E, T]
    cum = onehot.cumsum(1)
    pos = cum.gather(0, e[None])[0] - 1 + offset.long()[e]
    kept = (e >= lo) & (e < hi) & (pos < capacity)
    slot = torch.where(kept, (e - lo) * capacity + pos, -1)
    n_slots = (hi - lo) * capacity
    # Every token not kept writes the one spare entry past the slots.
    token_of_slot = torch.full((n_slots + 1,), -1, dtype=torch.long,
                               device=e.device)
    token_of_slot.scatter_(0, torch.where(kept, slot, n_slots),
                           torch.arange(e.numel(), device=e.device))
    return (pos.int(), slot.int(), token_of_slot[:n_slots].int(),
            onehot.sum(1).int(), (pos < capacity).sum().int().reshape(1))


def _padded_index(idx, n_rows):
    """idx with every negative entry pointing at row n_rows."""
    return torch.where(idx < 0, n_rows, idx).long()


def gather_rows_plain(src, idx, scale=None):
    """gather_rows' function: index_select on src with a zero row after
    it."""
    at = _padded_index(idx, src.shape[0])
    rows = torch.cat([src, src.new_zeros(1, src.shape[1])]).index_select(0, at)
    if scale is None:
        return rows
    return (rows.float() * scale.float()[:, None]).to(src.dtype)


def route_topk_plain(expert, k: int, lo: int, hi: int):
    """route_topk's function: a cumsum of the held experts' one-hot along
    the pairs, each expert's rows after the lower experts'."""
    e = expert.reshape(-1).long()
    n, held = e.numel(), hi - lo
    local = e - lo
    inside = (local >= 0) & (local < held)
    onehot = F.one_hot(torch.where(inside, local, held), held + 1)[:, :held]
    counts = onehot.sum(0)
    start = counts.cumsum(0) - counts
    pos = (onehot.cumsum(0) * onehot).sum(1) - 1
    slot = torch.where(inside, start[local.clamp(0, held - 1)] + pos, -1)
    pair_of_row = torch.full((n,), -1, dtype=torch.long, device=e.device)
    pair_of_row[slot[inside]] = torch.arange(n, device=e.device)[inside]
    token_of_row = torch.where(pair_of_row >= 0, pair_of_row // k, -1)
    offsets = torch.cat([start, counts.sum().reshape(1)])
    stats = torch.stack([counts.sum(), counts.max()])
    return (slot.int(), pair_of_row.int(), token_of_row.int(), offsets.int(),
            stats.int())


def combine_rows_plain(src, idx, gate, k: int):
    """combine_rows' function as the kernel rounds it: each token's k
    rows in order, each added as one fused multiply-add in fp32 (the
    fp64 sum of the fp32 total and the product, which fp64 holds
    exactly, rounded once to fp32), the total rounded to src's dtype."""
    rows = gather_rows_plain(src, idx).double().view(-1, k, src.shape[1])
    gates = (torch.ones(idx.numel(), dtype=torch.float64, device=src.device)
             if gate is None else gate.float().double()).view(-1, k, 1)
    acc = torch.zeros(rows.shape[0], src.shape[1], device=src.device)
    for j in range(k):
        acc = (acc.double() + gates[:, j] * rows[:, j]).float()
    return acc.to(src.dtype)


def pair_dot_plain(a, b, idx, k: int):
    """pair_dot's function, summed by torch.sum in fp32."""
    a_rows = a.float().repeat_interleave(k, 0)
    return (a_rows * gather_rows_plain(b, idx).float()).sum(-1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [N, D] as the row kernels take it: bf16 or fp32, D a multiple of
    ROW_MULTIPLE, rows contiguous from a 16-byte boundary."""
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"MoE row kernels take bfloat16 or float32, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[1] % ROW_MULTIPLE:
        raise ValueError(f"rows must be [N, D] with D a multiple of "
                         f"{ROW_MULTIPLE}, got {tuple(x.shape)}")
    if not (x.is_contiguous() and x.data_ptr() % 16 == 0):
        x = x.contiguous()
    return x


def _index(idx: torch.Tensor, n: int) -> torch.Tensor:
    if idx.shape != (n,):
        raise ValueError(f"index of shape {tuple(idx.shape)} for {n} rows")
    return idx.to(torch.int32).contiguous()


def route(expert, offset, capacity: int, lo: int, hi: int):
    """(pos [T], slot [T], token_of_slot [(hi - lo) * capacity], counts
    [E], kept [1]), int32, of expert [T] (each token's expert in token
    order) and offset [E] (positions to continue from)."""
    if not 0 <= lo < hi <= offset.numel():
        raise ValueError(f"experts [{lo}, {hi}) outside [0, {offset.numel()})")
    if _cuda.device_of(expert, "MoE") == "cpu":
        return route_plain(expert, offset, capacity, lo, hi)
    expert = expert.to(torch.int32).contiguous()
    offset = offset.to(torch.int32).contiguous()
    t, n_experts = expert.numel(), offset.numel()
    pos, slot = (torch.empty(t, dtype=torch.int32, device=expert.device)
                 for _ in range(2))
    token_of_slot = torch.empty((hi - lo) * capacity, dtype=torch.int32,
                                device=expert.device)
    counts = torch.empty(n_experts, dtype=torch.int32, device=expert.device)
    kept = torch.empty(1, dtype=torch.int32, device=expert.device)
    _cuda.launch("moe_route", expert, expert.data_ptr(), offset.data_ptr(),
                 pos.data_ptr(), slot.data_ptr(), token_of_slot.data_ptr(),
                 counts.data_ptr(), kept.data_ptr(), t, n_experts, capacity,
                 lo, hi)
    return pos, slot, token_of_slot, counts, kept


def gather_rows(src, idx, scale=None):
    """dst [len(idx), D] of src [N, D]: row i is scale[i] * src[idx[i]]
    (scale fp32), or zeros where idx[i] < 0; None copies the rows as
    they are."""
    if _cuda.device_of(src, "MoE") == "cpu":
        return gather_rows_plain(src, idx, scale)
    src = _rows(src)
    n = idx.numel()
    idx = _index(idx, n)
    if scale is not None:
        scale = scale.float().contiguous()
        if scale.shape != (n,):
            raise ValueError(f"scale of shape {tuple(scale.shape)}, want "
                             f"({n},)")
    dst = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    _cuda.launch("moe_gather_rows", src, src.data_ptr(), idx.data_ptr(),
                 None if scale is None else scale.data_ptr(), dst.data_ptr(),
                 n, src.shape[1], ROW_DTYPES[src.dtype])
    return dst


def route_topk(expert, k: int, lo: int, hi: int):
    """(slot [P], pair_of_row [P], token_of_row [P], offsets [hi - lo + 1],
    stats [2]), int32, of expert [T, k] (each token's k experts; P = T·k
    pairs in (b, s, k) order) over the held experts [lo, hi): each pair's
    row in the held experts' buffer (-1 where not held), rows [0, N) the
    pair and token they hold (the rest unspecified), each held expert's
    first row then N, and (N, the largest held expert's rows)."""
    if not (0 <= lo < hi and hi - lo <= MAX_HELD):
        raise ValueError(f"held experts [{lo}, {hi}): between 1 and "
                         f"{MAX_HELD} of them")
    if _cuda.device_of(expert, "MoE") == "cpu":
        return route_topk_plain(expert, k, lo, hi)
    expert = expert.reshape(-1).to(torch.int32).contiguous()
    n = expert.numel()
    slot, pair_of_row, token_of_row = (
        torch.empty(n, dtype=torch.int32, device=expert.device)
        for _ in range(3))
    offsets = torch.empty(hi - lo + 1, dtype=torch.int32,
                          device=expert.device)
    stats = torch.empty(2, dtype=torch.int32, device=expert.device)
    _cuda.launch("moe_route_topk", expert, expert.data_ptr(),
                 slot.data_ptr(), pair_of_row.data_ptr(),
                 token_of_row.data_ptr(), offsets.data_ptr(),
                 stats.data_ptr(), n, k, lo, hi)
    return slot, pair_of_row, token_of_row, offsets, stats


def combine_rows(src, idx, gate, k: int):
    """out [len(idx) // k, D] of src [N, D]: row t is sum_j gate[t·k + j] ·
    src[idx[t·k + j]] over the j with idx >= 0 (gate None: the plain
    sum), in fp32 and rounded once; zeros where none is."""
    if idx.numel() % k:
        raise ValueError(f"{idx.numel()} pairs for k = {k}")
    if _cuda.device_of(src, "MoE") == "cpu":
        return combine_rows_plain(src, idx, gate, k)
    src = _rows(src)
    n = idx.numel() // k
    idx = _index(idx, n * k)
    if gate is not None:
        gate = gate.float().contiguous()
        if gate.shape != (n * k,):
            raise ValueError(f"gate of shape {tuple(gate.shape)}, want "
                             f"({n * k},)")
    dst = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    _cuda.launch("moe_combine_rows", src, src.data_ptr(), idx.data_ptr(),
                 None if gate is None else gate.data_ptr(), dst.data_ptr(),
                 n, k, src.shape[1], ROW_DTYPES[src.dtype])
    return dst


def pair_dot(a, b, idx, k: int):
    """out [len(idx)] fp32 of a [T, D] and b [N, D]: sum_d a[p // k, d] ·
    b[idx[p], d], or 0 where idx[p] < 0."""
    if _cuda.device_of(a, "MoE") == "cpu":
        return pair_dot_plain(a, b, idx, k)
    a, b = _rows(a), _rows(b)
    if a.dtype != b.dtype or a.shape[1] != b.shape[1]:
        raise ValueError(f"rows differ: {a.dtype} {tuple(a.shape)}, "
                         f"{b.dtype} {tuple(b.shape)}")
    idx = _index(idx, a.shape[0] * k)
    out = torch.empty(idx.numel(), dtype=torch.float32, device=a.device)
    _cuda.launch("moe_pair_dot", a, a.data_ptr(), b.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), idx.numel(), k, a.shape[1],
                 ROW_DTYPES[a.dtype])
    return out
