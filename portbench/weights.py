"""The weights of a cell, made from its seed on the device in one draw.

A family's reference lists its leaves as (path, shape, init). ``make``
draws one flat buffer of normals from a generator on the device and
hands out each leaf as a view into it, scaled in place (or filled with
ones for norm scales). The program is built on those views; the
reference, after the program is gone, calls ``make`` again with the same
seed and gets the same numbers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

# Leaf offsets are multiples of this many elements (256 bytes in fp32),
# so every leaf starts as aligned as a tensor of its own.
ALIGN = 64
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], Tuple[Any, ...]]


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for `stream` (weights, tokens, ...) of a run's
    seed; any whole number maps into the generator's 64 bits."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63)


def leaf_name(path) -> str:
    return ".".join(str(p) for p in path)


def _set(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def offsets(leaves: Sequence[Leaf]) -> Tuple[List[int], int]:
    """(offset of each leaf in the flat buffer, its length)."""
    offs, total = [], 0
    for _, shape, _ in leaves:
        offs.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    return offs, total


def slices(leaves: Sequence[Leaf]) -> List[slice]:
    offs, _ = offsets(leaves)
    return [slice(off, off + math.prod(shape))
            for (_, shape, _), off in zip(leaves, offs)]


def tree_of(flat: torch.Tensor, leaves: Sequence[Leaf]) -> Dict[str, Any]:
    """The parameter tree of views into `flat` (differentiable views when
    `flat` requires grad)."""
    tree: Dict[str, Any] = {}
    for (path, shape, _), sl in zip(leaves, slices(leaves)):
        _set(tree, path, flat[sl].view(shape))
    return tree


def make(leaves: Sequence[Leaf], seed: int, device) -> Tuple[torch.Tensor,
                                                              Dict[str, Any]]:
    """(flat fp32 buffer, tree of leaf views into it) for `seed`."""
    _, total = offsets(leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree = tree_of(flat, leaves)
    for (path, _, init) in leaves:
        view = get(tree, path)
        if init[0] == "ones":
            view.fill_(1.0)
        else:
            view.mul_(init[1])
    return flat, tree


def leaf_norms(a: torch.Tensor, b: torch.Tensor, leaves: Sequence[Leaf],
               scale: float = 1.0) -> List[float]:
    """Per leaf, scale * ||a - b|| over two flat buffers of `leaves`."""
    norms = torch.stack([torch.linalg.vector_norm(a[sl] - b[sl])
                         for sl in slices(leaves)])
    return (norms.double() * scale).tolist()


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree

