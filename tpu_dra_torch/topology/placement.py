"""Contiguity, the ResourceSlice topology view and the ComputeDomain
member summary (the parts of tpu_dra/topology/placement.py that
meshexport and the compute-domain controller need).

``is_contiguous_block`` says whether a coordinate set is one cuboid of a
block; ``node_topology_from_slices`` builds one node's fabric view from
its published GPU devices; ``domain_topology`` summarises a domain's
member set by NVLink clique. Placement scoring comes with the scheduler.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_dra_torch.topology.mesh import (
    Coord, NvlinkFabric, TopologyError, block_mesh, parse_topology,
)


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
