"""All-to-all (Ulysses-style) sequence parallelism (counterpart of
tpu_dra/workloads/ulysses.py).

Instead of rotating K/V blocks around a ring for axis-size partial
steps (ringattention.py), all-to-alls re-shard the activations from
sequence-sharded [B, S/N, H, D] to head-sharded [B, S, H/N, D], exact
full-sequence attention runs on each rank's head subset (the CUDA
kernels on a card, with RoPE fused at global positions), and one more
all-to-all shards back. Heads must divide by the axis size.
"""

from __future__ import annotations

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads.flashattention import attend


def ulysses_attention(q, k, v, *, group, causal: bool = True,
                      impl: str = "auto", rope: bool = False):
    """This rank's body: q, k, v are its LOCAL sequence blocks
    [B, S/N, H, D] with H divisible by the group's size N. Returns the
    local sequence block of the exact attention output."""
    n = _dist.group_size(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs heads % axis_size == 0 (H={h}, N={n})")

    def to_heads(x):
        # [B, S/N, H, D] -> [B, S, H/N, D]: split the heads across the
        # group, gather the sequence.
        return _dist.all_to_all(x, group, split_axis=2, concat_axis=1)

    out = attend(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                 impl=impl, rope=rope)
    # [B, S, H/N, D] -> [B, S/N, H, D]: scatter the sequence, gather heads.
    return _dist.all_to_all(out, group, split_axis=1, concat_axis=2)


def make_ulysses_attention(mesh, axis_name: str = "seq", causal: bool = True,
                           impl: str = "auto", rope: bool = False):
    """All-to-all sequence-parallel attention over `mesh`'s `axis_name`
    axis: fn(q, k, v) on this rank's sequence blocks [B, S/N, H, D]
    returns its block of the output; H must divide by the axis size."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group=group, causal=causal,
                                 impl=impl, rope=rope)

    return fn
