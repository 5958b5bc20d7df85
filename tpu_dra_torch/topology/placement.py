"""Block shapes, the free-set scanner and fragmentation scoring;
contiguity, the ResourceSlice topology view and the ComputeDomain member
summary (counterpart of tpu_dra/topology/placement.py).

``is_contiguous_block`` says whether a coordinate set is one cuboid of a
block; ``node_topology_from_slices`` builds one node's fabric view from
its published GPU devices; ``domain_topology`` summarises a domain's
member set by NVLink clique.

The scheduler's half: ``best_placement`` picks, among the cuboids of a
count that fit a free coordinate set, the one that leaves the fewest
free neighbors around it (best-fit packing), ``max_free_cuboid`` is the
fragmentation observable, ``rank_candidate_nodes`` orders nodes so a
multi-node placement fills one NVLink clique in worker order, and
``allocation_violations`` checks cluster truth for scattered picks. They
read any block with ``dims``, ``wrap`` and ``neighbors``: on an
``NvlinkFabric`` every GPU neighbors every other, so every placement of
a count scores alike and the pick is the first cuboid in PCI order; a
block whose neighbors are a lattice's (the reference's ``Mesh``) gets
the reference's best fit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_dra_torch.topology.mesh import (
    Coord, NvlinkFabric, TopologyError, block_mesh, parse_topology,
)

Shape = Tuple[int, int, int]


def _surface(shape: Shape) -> int:
    a, b, c = shape
    return 2 * (a * b + b * c + c * a)


def enumerate_shapes(count: int, dims: Shape) -> List[Shape]:
    """All cuboid orientations (a,b,c) with a*b*c == count that fit in
    `dims`, most compact first (smallest surface area), ties broken on
    the shape tuple."""
    shapes: Set[Shape] = set()
    for a in range(1, min(count, dims[0]) + 1):
        if count % a:
            continue
        rest = count // a
        for b in range(1, min(rest, dims[1]) + 1):
            if rest % b:
                continue
            c = rest // b
            if c <= dims[2]:
                shapes.add((a, b, c))
    return sorted(shapes, key=lambda s: (_surface(s), s))


def _axis_bases(size: int, dim: int, wrap: bool) -> range:
    """Base offsets along one axis: every offset when the axis wraps (a
    placement may straddle the seam), sliding-window otherwise; a
    full-span shape has exactly one distinct placement."""
    if size == dim:
        return range(1)
    if wrap:
        return range(dim)
    return range(dim - size + 1)


def placement_coords(base: Coord, shape: Shape, mesh) -> Tuple[Coord, ...]:
    axes = []
    for i in range(3):
        if mesh.wrap[i]:
            axes.append([(base[i] + d) % mesh.dims[i]
                         for d in range(shape[i])])
        else:
            axes.append([base[i] + d for d in range(shape[i])])
    return tuple(itertools.product(*axes))  # type: ignore[return-value]


def enumerate_placements(mesh, count: int):
    """Every (shape, base, coords) placement of `count` devices on
    `mesh`: each a contiguous cuboid inside its bounds."""
    for shape in enumerate_shapes(count, mesh.dims):
        for bx in _axis_bases(shape[0], mesh.dims[0], mesh.wrap[0]):
            for by in _axis_bases(shape[1], mesh.dims[1], mesh.wrap[1]):
                for bz in _axis_bases(shape[2], mesh.dims[2], mesh.wrap[2]):
                    base = (bx, by, bz)
                    yield shape, base, placement_coords(base, shape, mesh)


def enumerate_index(mesh, count: int):
    """enumerate_placements with a shape-order index for tie-breaking."""
    shape_order: Dict[Shape, int] = {}
    for shape, base, coords in enumerate_placements(mesh, count):
        idx = shape_order.setdefault(shape, len(shape_order))
        yield idx, (shape, base, coords)


def fragmentation_score(coords: Iterable[Coord], free_after: Set[Coord],
                        mesh) -> int:
    """Free cells adjacent to the placement once it is carved out: LOW
    means the placement nests into an already-fragmented pocket, HIGH
    means it was punched into the middle of a large free region."""
    score = 0
    for c in coords:
        for n in mesh.neighbors(c):
            if n in free_after:
                score += 1
    return score


def best_placement(mesh, free: Set[Coord], count: int
                   ) -> Optional[Tuple[Coord, ...]]:
    """The best-scoring contiguous placement of `count` devices inside
    `free`, or None when no cuboid of that count fits. Deterministic:
    ties break on (shape enumeration order, base coord)."""
    if count <= 0 or count > len(free):
        return None
    best: Optional[Tuple[Coord, ...]] = None
    best_key: Optional[Tuple[int, int, Coord]] = None
    for shape_idx, (_shape, base, coords) in enumerate_index(mesh, count):
        if not all(c in free for c in coords):
            continue
        after = free.difference(coords)
        key = (fragmentation_score(coords, after, mesh), shape_idx, base)
        if best_key is None or key < best_key:
            best_key = key
            best = coords
    return best


def max_free_cuboid(mesh, free: Set[Coord]) -> int:
    """Volume of the largest cuboid wholly inside `free` (a churned
    block whose largest free cuboid collapses can no longer host big
    claims even at low utilization)."""
    if not free:
        return 0
    volumes = sorted({a * b * c
                      for a in range(1, mesh.dims[0] + 1)
                      for b in range(1, mesh.dims[1] + 1)
                      for c in range(1, mesh.dims[2] + 1)
                      if a * b * c <= len(free)}, reverse=True)
    for vol in volumes:
        for _shape, _base, coords in enumerate_placements(mesh, vol):
            if all(c in free for c in coords):
                return vol
    return 1


def is_contiguous_block(coords: Iterable[Coord],
                        fabric: NvlinkFabric) -> bool:
    """True iff `coords` is exactly one cuboid of `fabric` (each axis
    projection a single run of consecutive values, and the set their
    full cartesian product). On an NVSwitch this is about PCI order, not
    cost: every pair is one hop apart either way."""
    pts = list(coords)
    block = set(pts)
    if len(block) != len(pts) or not pts:
        return False
    runs = []
    for axis in range(3):
        vals = sorted({c[axis] for c in block})
        if vals != list(range(vals[0], vals[0] + len(vals))):
            return False
        runs.append(vals)
    return block == set(itertools.product(*runs))


def _attr(dev: Dict, name: str, kind: str):
    a = (dev.get("attributes") or {}).get(name) or {}
    return a.get(kind)


@dataclass
class NodeTopology:
    """One node's view of the fabric, extracted from its published
    ResourceSlice GPU devices. Coords are normalized to the node's own
    block (offset removed)."""

    fabric: NvlinkFabric
    coord_of: Dict[str, Coord] = field(default_factory=dict)   # device name
    name_of: Dict[Coord, str] = field(default_factory=dict)
    driver_of: Dict[str, str] = field(default_factory=dict)
    clique_id: str = ""
    worker_index: int = 0


def node_topology_from_slices(slices: List[Dict]) -> Optional[NodeTopology]:
    """Build a NodeTopology from one node's ResourceSlices, or None when
    the node publishes no usable topology (no GPU devices carry
    coordinates, or the coordinates are invalid)."""
    raw: Dict[str, Tuple[Coord, str]] = {}
    clique_id = ""
    worker = 0
    declared: Optional[Tuple[int, int, int]] = None
    for sl in sorted(slices, key=lambda s: s["metadata"]["name"]):
        spec = sl.get("spec") or {}
        driver = spec.get("driver", "")
        for dev in spec.get("devices") or []:
            if _attr(dev, "type", "string") not in (None, "gpu"):
                continue  # MIG devices partition a GPU; the GPU carries coords
            cx = _attr(dev, "coordX", "int")
            cy = _attr(dev, "coordY", "int")
            cz = _attr(dev, "coordZ", "int")
            if cx is None or cy is None or cz is None:
                continue
            raw[dev["name"]] = ((int(cx), int(cy), int(cz)), driver)
            clique_id = clique_id or (_attr(dev, "clique", "string") or "")
            worker = int(_attr(dev, "workerIndex", "int") or 0)
            declared = declared or parse_topology(
                _attr(dev, "fabricTopology", "string") or "")
    if len(raw) < 2:
        return None  # nothing to lay out
    try:
        fabric, offset = block_mesh((c for c, _ in raw.values()),
                                  slice_dims=declared)
    except TopologyError:
        return None
    topo = NodeTopology(fabric=fabric, clique_id=clique_id, worker_index=worker)
    for name, (c, driver) in raw.items():
        local = (c[0] - offset[0], c[1] - offset[1], c[2] - offset[2])
        topo.coord_of[name] = local
        topo.name_of[local] = name
        topo.driver_of[name] = driver
    return topo


def domain_topology(members: List[Dict]) -> Dict:
    """ComputeDomain member-set NVLink summary from ``cd.status.nodes``
    entries (each carries the daemon-registered ``cliqueID``/``index``):
    how many NVLink cliques the domain spans and whether it is
    clique-aligned (one clique, contiguous worker indices).

    A member with an empty cliqueID reaches its peers over the network
    only: it belongs to no clique, and a domain that holds one is not
    aligned. (The reference counts its empty slice id as one slice; here
    that would read two HGX nodes without a fabric manager as one NVLink
    domain.)"""
    clique_ids = sorted({n.get("cliqueID", "") for n in members} - {""})
    loose = any(not n.get("cliqueID", "") for n in members)
    aligned = False
    if len(clique_ids) == 1 and not loose:
        idx = sorted(n.get("index", 0) for n in members)
        aligned = idx == list(range(idx[0], idx[0] + len(idx)))
    return {"cliques": len(clique_ids), "cliqueAligned": aligned}


def rank_candidate_nodes(infos: List[Tuple[str, str, int]]) -> List[str]:
    """Order candidate nodes so multi-node placements land on ONE NVLink
    clique: group by clique id, largest group first, inside a group by
    worker index; nodes with no clique trail in name order. `infos` is
    (node_name, clique_id, worker_index)."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    loose: List[str] = []
    for name, clique_id, worker in infos:
        if clique_id:
            groups.setdefault(clique_id, []).append((worker, name))
        else:
            loose.append(name)
    out: List[str] = []
    for clique_id in sorted(groups, key=lambda s: (-len(groups[s]), s)):
        out.extend(name for _w, name in sorted(groups[clique_id]))
    out.extend(sorted(loose))
    return out


def allocation_violations(claims: List[Dict], slices: List[Dict]
                          ) -> List[str]:
    """Every allocated multi-GPU claim on a node that publishes
    coordinates must be a contiguous block. Built from cluster truth
    (claim listing + ResourceSlice listing), independent of any
    scheduler state."""
    by_node: Dict[str, List[Dict]] = {}
    for sl in slices:
        node = (sl.get("spec") or {}).get("nodeName")
        if node:
            by_node.setdefault(node, []).append(sl)
    topos: Dict[str, Optional[NodeTopology]] = {
        node: node_topology_from_slices(sls)
        for node, sls in by_node.items()}
    out: List[str] = []
    for claim in claims:
        alloc = (claim.get("status") or {}).get("allocation") or {}
        results = (alloc.get("devices") or {}).get("results") or []
        per_pool: Dict[str, List[str]] = {}
        for r in results:
            per_pool.setdefault(r.get("pool", ""), []).append(
                r.get("device", ""))
        for pool, devices in per_pool.items():
            topo = topos.get(pool)
            if topo is None or len(devices) < 2:
                continue
            coords = [topo.coord_of[d] for d in devices
                      if d in topo.coord_of]
            if len(coords) != len(devices):
                continue  # MIG/unknown devices: no GPU-level layout
            if not is_contiguous_block(coords, topo.fabric):
                name = claim.get("metadata", {}).get("name", "?")
                out.append(
                    f"claim {name}: devices {sorted(devices)} on {pool} "
                    f"are not a contiguous block (coords "
                    f"{sorted(coords)})")
    return out
