"""NVLink fabric model (counterpart of tpu_dra/topology/mesh.py).

A node's GPUs of one NVLink clique hang off the same NVSwitches: every
pair is one hop apart, whatever their positions. The driver still gives
each GPU a coordinate (its PCI-bus-id rank in the clique at (i, 0, 0),
``gpuinfo.assign_fabric_coords``) so that every process derives the same
rank order from a claim, as on the reference's ICI cuboids; the
``NvlinkFabric`` block keeps the cuboid's bounds and validation (no
torus wraparound) but measures distance as the switch does.

Coordinate validation happens at publish time (``DeviceState`` building
its allocatable inventory): duplicate or out-of-bounds coordinates mean
the inventory lies about the fabric — reject early, loudly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Coord = Tuple[int, int, int]


class TopologyError(ValueError):
    """Invalid fabric description (duplicate/out-of-bounds coords,
    malformed topology strings)."""


def format_topology(dims: Sequence[int]) -> str:
    """(8, 1, 1) -> '8x1x1' (the ``fabricTopology`` attribute)."""
    return "x".join(str(d) for d in dims)


def parse_topology(text: str) -> Optional[Tuple[int, int, int]]:
    """'8x1x1' -> (8, 1, 1); '8' -> (8, 1, 1); None when malformed."""
    if not text:
        return None
    parts = text.lower().split("x")
    if not 1 <= len(parts) <= 3 or not all(p.isdigit() for p in parts):
        return None
    dims = [int(p) for p in parts]
    if any(d < 1 for d in dims):
        return None
    while len(dims) < 3:
        dims.append(1)
    return (dims[0], dims[1], dims[2])


@dataclass(frozen=True)
class NvlinkFabric:
    """An NVSwitch domain laid out as a block of `dims`: all-to-all, so
    any two distinct GPUs are one hop apart and each is every other's
    neighbor. A line's hop count would charge a ring's closing step
    n - 1 hops that the switch does not have. Coords are local to the
    block (0-based)."""

    dims: Tuple[int, int, int]

    @property
    def wrap(self) -> Tuple[bool, bool, bool]:
        """No axis wraps: the switch has no ring to close."""
        return (False, False, False)

    def all_coords(self) -> List[Coord]:
        return [(x, y, z)
                for x in range(self.dims[0])
                for y in range(self.dims[1])
                for z in range(self.dims[2])]

    def neighbors(self, c: Coord) -> List[Coord]:
        return [o for o in self.all_coords() if o != c]

    def distance(self, a: Coord, b: Coord) -> int:
        return 0 if a == b else 1


def block_mesh(coords: Iterable[Coord],
               slice_dims: Optional[Tuple[int, int, int]] = None,
               ) -> Tuple[NvlinkFabric, Coord]:
    """(fabric, offset) for a host's block of GPUs: dims are the bounding
    extent of `coords`, offset the per-dim minimum (callers normalize by
    subtracting it). Raises TopologyError on duplicates, negative coords,
    or coords outside declared `slice_dims`."""
    pts = list(coords)
    seen = set()
    for c in pts:
        if c in seen:
            raise TopologyError(f"duplicate GPU coordinate {c}")
        seen.add(c)
        if any(v < 0 for v in c):
            raise TopologyError(f"negative GPU coordinate {c}")
        if slice_dims is not None and any(c[i] >= slice_dims[i]
                                          for i in range(3)):
            raise TopologyError(
                f"GPU coordinate {c} outside declared fabric topology "
                f"{format_topology(slice_dims)}")
    if not pts:
        return NvlinkFabric(dims=(0, 0, 0)), (0, 0, 0)
    lo = tuple(min(c[i] for c in pts) for i in range(3))
    hi = tuple(max(c[i] for c in pts) for i in range(3))
    dims = tuple(hi[i] - lo[i] + 1 for i in range(3))
    return NvlinkFabric(dims=dims), lo  # type: ignore[arg-type]


def validate_gpus(gpus: Iterable) -> None:
    """Publish-time validation of a discovered GPU inventory: within each
    (clique_id, worker_index) block, coordinates must be unique,
    non-negative, and inside the declared ``slice_topology`` when one is
    published. A block where EVERY GPU sits at (0,0,0) with no declared
    topology published no fabric information at all — "no topology",
    not a duplicate-coordinate lie — and passes."""
    groups: Dict[Tuple[str, int], List] = {}
    for gpu in gpus:
        groups.setdefault((gpu.clique_id, gpu.worker_index),
                          []).append(gpu)
    for (clique_id, worker), members in groups.items():
        if (len(members) > 1
                and all(g.coords == (0, 0, 0) for g in members)
                and not any(g.slice_topology for g in members)):
            continue  # coordinate-less inventory: nothing to validate
        declared = None
        for gpu in members:
            topo = parse_topology(gpu.slice_topology)
            if topo is not None:
                if declared is not None and topo != declared:
                    raise TopologyError(
                        f"GPUs of clique {clique_id!r} worker {worker} "
                        f"declare conflicting topologies "
                        f"{format_topology(declared)} vs "
                        f"{format_topology(topo)}")
                declared = topo
        try:
            block_mesh((g.coords for g in members), slice_dims=declared)
        except TopologyError as e:
            raise TopologyError(
                f"invalid GPU topology (clique={clique_id!r} "
                f"worker={worker}): {e}") from e
