"""Allocation -> mesh contract for GPUs: coordinate export, rank order,
NVLink cost (counterpart of tpu_dra/topology/meshexport.py).

The driver prepares a claim's GPUs; a workload container then lays its
device mesh over exactly those GPUs, in an order every process agrees
on. This module owns the part of that contract that needs no framework:

- **the claim env** (``export_topology_env`` and ``ENV_*``): written at
  prepare time into the claim's CDI spec next to the GPUs' UUIDs —

  ==========================  =========================================
  ``CUDA_VISIBLE_DEVICES``    the claim's GPU UUIDs, in node-index order
  ``NVIDIA_VISIBLE_DEVICES``  the same, for the container toolkit
  ``GPU_VISIBLE_INDICES``     the GPUs' node indices, in the same order
  ``GPU_COORDS``              ``index:x.y.z`` per GPU, comma-separated
  ``GPU_FABRIC_TOPOLOGY``     the NVLink domain's declared dims ("8x1x1")
  ``GPU_GENERATION``          the architecture ("hopper")
  ``GPU_CLIQUE_ID``           the NVLink clique id, where there is one
  ``GPU_WORKER_INDEX``        the node's index among the domain's workers
  ==========================  =========================================

- **rank order** (``snake_order``): a pure function of the coordinate
  set, so every process computes the same order with no coordination;
- **NVLink cost** (``ring_hops`` / ``modeled_ring_allreduce_gbps``): on
  an NVSwitch every step of a ring is one hop, and the modeled bandwidth
  is the published per-GPU NVLink rate;
- **MeshPlan** (``plan_from_coords`` and its adapters): the validated,
  ordered handoff to ``workloads.meshbuild``. Construction refuses lies:
  malformed, duplicate or out-of-bounds coordinates, a visible GPU with
  no coordinate, a UUID list whose count disagrees with the index list,
  and non-contiguous or disagreeing worker sets.

Fault sites ``mesh.build`` and ``workload.launch`` guard the two seams
where the data plane first trusts control-plane output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import MESH_BUILDS
from tpu_dra_torch.infra.trace import ENV_TRACEPARENT, TRACER
from tpu_dra_torch.topology.mesh import (
    Coord, NvlinkFabric, format_topology, parse_topology,
)
from tpu_dra_torch.topology.placement import (
    is_contiguous_block, node_topology_from_slices,
)

# NVLink bandwidth per GPU and direction, GB/s, from the parts' data
# sheets: an H100 SXM has 18 NVLink 4 links, 900 GB/s in both directions
# together. A spec number for the model, not a measurement.
NVLINK_GBPS: Dict[str, float] = {
    "hopper": 450.0,
}

# Env keys of the exported contract (also consumed by workloads.meshbuild).
ENV_CUDA_VISIBLE = "CUDA_VISIBLE_DEVICES"
ENV_NVIDIA_VISIBLE = "NVIDIA_VISIBLE_DEVICES"
ENV_VISIBLE_INDICES = "GPU_VISIBLE_INDICES"
ENV_GPU_COORDS = "GPU_COORDS"
ENV_FABRIC_TOPOLOGY = "GPU_FABRIC_TOPOLOGY"
ENV_GENERATION = "GPU_GENERATION"
ENV_CLIQUE_ID = "GPU_CLIQUE_ID"
ENV_WORKER_INDEX = "GPU_WORKER_INDEX"
# A worker's identity in a multi-node domain (set by the compute-domain
# daemon, next to the claim env).
ENV_WORKER_ID = "GPU_WORKER_ID"
ENV_WORKER_HOSTNAMES = "GPU_WORKER_HOSTNAMES"


class MeshBuildError(ValueError):
    """The allocation result cannot back a trustworthy mesh (rank or
    topology mismatch, duplicate/out-of-bounds coordinates, missing
    coordinate export). Refusal, not degradation."""


# ---------------------------------------------------------------------------
# Coordinate export (prepare-time env, next to CUDA_VISIBLE_DEVICES)
# ---------------------------------------------------------------------------

def format_gpu_coords(coords_by_index: Dict[int, Coord]) -> str:
    """{0: (0,0,0), 1: (1,0,0)} -> '0:0.0.0,1:1.0.0' (index-sorted)."""
    return ",".join(f"{i}:{c[0]}.{c[1]}.{c[2]}"
                    for i, c in sorted(coords_by_index.items()))


def parse_gpu_coords(text: str) -> Dict[int, Coord]:
    """Inverse of format_gpu_coords; raises MeshBuildError on malformed
    entries (a torn env var must not silently drop GPUs)."""
    out: Dict[int, Coord] = {}
    if not text:
        return out
    for part in text.split(","):
        try:
            idx_s, coord_s = part.split(":")
            x, y, z = coord_s.split(".")
            idx, c = int(idx_s), (int(x), int(y), int(z))
        except ValueError as e:
            raise MeshBuildError(
                f"malformed {ENV_GPU_COORDS} entry {part!r}") from e
        if idx in out:
            raise MeshBuildError(
                f"duplicate GPU index {idx} in {ENV_GPU_COORDS}")
        out[idx] = c
    return out


def export_topology_env(gpus: Iterable) -> Dict[str, str]:
    """The claim-env topology block for an allocated GPU set, or {} when
    the inventory published no fabric information (every GPU at (0,0,0)
    with no declared topology: exporting a fabricated coordinate would
    feed the mesh builder a guess, and plan_from_env refuses instead).
    The backends always declare a topology (gpuinfo.assign_fabric_coords),
    so a lone GPU at (0,0,0) exports "1x1x1" and can be planned."""
    members = list(gpus)
    if not members:
        return {}
    if (all(g.coords == (0, 0, 0) for g in members)
            and not any(g.slice_topology for g in members)):
        return {}
    declared = next((g.slice_topology for g in members if g.slice_topology),
                    "")
    env = {
        ENV_GPU_COORDS: format_gpu_coords(
            {g.index: g.coords for g in members}),
        ENV_GENERATION: members[0].generation,
        ENV_WORKER_INDEX: str(members[0].worker_index),
    }
    if declared:
        env[ENV_FABRIC_TOPOLOGY] = declared
    if members[0].clique_id:
        env[ENV_CLIQUE_ID] = members[0].clique_id
    return env


# ---------------------------------------------------------------------------
# Rank -> coordinate mapping and the NVLink cost model
# ---------------------------------------------------------------------------

def snake_order(coords: Iterable[Coord]) -> List[Coord]:
    """Deterministic boustrophedon order over the coordinate set's
    bounding box: z-planes ascending, y-rows serpentine within a plane,
    x serpentine within a row. On a node's line of GPUs it is ascending
    PCI order. A pure function of the set: every process computes the
    same order from the same allocation."""
    pts = sorted(set(coords))
    if not pts:
        return []
    lo = tuple(min(c[i] for c in pts) for i in range(3))
    hi = tuple(max(c[i] for c in pts) for i in range(3))
    dx, dy = hi[0] - lo[0] + 1, hi[1] - lo[1] + 1

    def key(c: Coord):
        x, y, z = c[0] - lo[0], c[1] - lo[1], c[2] - lo[2]
        yy = y if z % 2 == 0 else dy - 1 - y
        row = z * dy + yy
        xx = x if row % 2 == 0 else dx - 1 - x
        return (z, yy, xx)

    return sorted(pts, key=key)


def ring_hops(ordered: Sequence[Coord], fabric: NvlinkFabric) -> List[int]:
    """Per-step hop distances of the ring over `ordered` (wrapping back
    to the first coord), on the fabric's own distance."""
    n = len(ordered)
    if n < 2:
        return []
    return [fabric.distance(ordered[i], ordered[(i + 1) % n])
            for i in range(n)]


def modeled_ring_allreduce_gbps(ordered: Sequence[Coord],
                                fabric: NvlinkFabric,
                                generation: str) -> float:
    """Hop-weighted ring all-reduce bandwidth model: each of the 2(n-1)
    ring steps moves payload/n bytes over that step's hop count, so algo
    bandwidth = link * n / (2(n-1) * mean_hop). 0 for a generation with
    no published NVLink figure in NVLINK_GBPS."""
    hops = ring_hops(ordered, fabric)
    if not hops:
        return 0.0
    n = len(ordered)
    mean_hop = sum(hops) / len(hops)
    link = NVLINK_GBPS.get(generation, 0.0)
    return link * n / (2.0 * (n - 1) * mean_hop)


def slice_mesh_for(dims: Tuple[int, int, int]) -> NvlinkFabric:
    """The NVLink domain for declared dims."""
    return NvlinkFabric(dims=dims)


# ---------------------------------------------------------------------------
# MeshPlan: the validated, ordered allocation -> mesh handoff
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshPlan:
    """One claim-set's allocation, ordered and costed for mesh
    construction. ``coords``/``gpu_keys`` are in RANK order (snake);
    ``order[r]`` is the arrival-order index of rank r, so a caller
    holding per-GPU resources in arrival order permutes them with it.
    Frozen: plans are snapshots, never mutated."""

    generation: str
    fabric_dims: Tuple[int, int, int]
    coords: Tuple[Coord, ...]
    gpu_keys: Tuple[Tuple[int, int], ...]   # (worker_index, gpu_index)
    order: Tuple[int, ...]
    contiguous: bool
    hops: Tuple[int, ...]
    hop_mean: float
    hop_max: int
    modeled_nvlink_gbps: float
    n_workers: int = 1

    @property
    def n_devices(self) -> int:
        return len(self.coords)


def plan_from_coords(coords_by_key: Dict[Tuple[int, int], Coord],
                     fabric_dims: Optional[Tuple[int, int, int]],
                     generation: str,
                     n_workers: int = 1) -> MeshPlan:
    """Validate + order one allocation into a MeshPlan.

    `coords_by_key` maps (worker_index, gpu_index) -> coordinate. Refuses
    duplicate coordinates, negative ones, coordinates outside the
    declared topology, and empty allocations. Without declared dims the
    bounding box serves."""
    FAULTS.check("mesh.build")
    if not coords_by_key:
        MESH_BUILDS.inc(labels={"outcome": "refused"})
        raise MeshBuildError("empty allocation: no GPUs to lay out")
    arrival = sorted(coords_by_key.items())
    seen: Dict[Coord, Tuple[int, int]] = {}
    for key, c in arrival:
        if any(v < 0 for v in c):
            MESH_BUILDS.inc(labels={"outcome": "refused"})
            raise MeshBuildError(f"negative coordinate {c} for GPU {key}")
        if c in seen:
            MESH_BUILDS.inc(labels={"outcome": "refused"})
            raise MeshBuildError(
                f"GPUs {seen[c]} and {key} share coordinate {c}")
        seen[c] = key
    if fabric_dims is None:
        lo = tuple(min(c[i] for c in seen) for i in range(3))
        hi = tuple(max(c[i] for c in seen) for i in range(3))
        if lo != (0, 0, 0):
            # Normalize an undeclared fabric to its own origin; the
            # arrival list shifts WITH it, so rank indices keep naming
            # the same GPUs.
            arrival = [(k, (c[0] - lo[0], c[1] - lo[1], c[2] - lo[2]))
                       for k, c in arrival]
            seen = {c: k for k, c in arrival}
            hi = tuple(hi[i] - lo[i] for i in range(3))
        fabric_dims = (hi[0] + 1, hi[1] + 1, hi[2] + 1)
    else:
        for c in seen:
            if any(c[i] >= fabric_dims[i] for i in range(3)):
                MESH_BUILDS.inc(labels={"outcome": "refused"})
                raise MeshBuildError(
                    f"coordinate {c} outside declared fabric topology "
                    f"{format_topology(fabric_dims)}")
    fabric = slice_mesh_for(fabric_dims)
    ordered = snake_order(seen)
    index_of = {c: i for i, (_k, c) in enumerate(arrival)}
    order = tuple(index_of[c] for c in ordered)
    gpu_keys = tuple(arrival[i][0] for i in order)
    hops = tuple(ring_hops(ordered, fabric))
    contiguous = is_contiguous_block(ordered, fabric)
    plan = MeshPlan(
        generation=generation,
        fabric_dims=fabric_dims,
        coords=tuple(ordered),
        gpu_keys=gpu_keys,
        order=order,
        contiguous=contiguous,
        hops=hops,
        hop_mean=(sum(hops) / len(hops)) if hops else 0.0,
        hop_max=max(hops) if hops else 0,
        modeled_nvlink_gbps=modeled_ring_allreduce_gbps(ordered, fabric,
                                                        generation),
        n_workers=n_workers,
    )
    MESH_BUILDS.inc(labels={
        "outcome": "ok" if contiguous else "fragmented"})
    return plan


def _env_gpu_coords(env: Dict[str, str], worker: int
                    ) -> Dict[Tuple[int, int], Coord]:
    """Validated {(worker, gpu_index): coord} from one claim env: the
    refusal contract shared by the single- and multi-worker plan paths.
    Refuses a missing coordinate export, a malformed index token, a UUID
    list whose count disagrees with the index list, and a visible GPU
    with no exported coordinate."""
    coords = parse_gpu_coords(env.get(ENV_GPU_COORDS, ""))
    if not coords:
        raise MeshBuildError(
            f"worker {worker} claim env exports no {ENV_GPU_COORDS}: "
            "the inventory published no topology (coordinate-less node)")
    visible = []
    for tok in (t.strip() for t in
                env.get(ENV_VISIBLE_INDICES, "").split(",") if t.strip()):
        if not tok.isdigit():
            # A torn env var must not silently drop GPUs.
            raise MeshBuildError(
                f"worker {worker} has a malformed {ENV_VISIBLE_INDICES} "
                f"entry {tok!r}")
        visible.append(int(tok))
    uuids = [u for u in env.get(ENV_CUDA_VISIBLE, "").split(",") if u]
    if uuids and len(uuids) != len(visible):
        raise MeshBuildError(
            f"worker {worker} {ENV_CUDA_VISIBLE} names {len(uuids)} GPUs "
            f"but {ENV_VISIBLE_INDICES} {len(visible)} (count mismatch)")
    missing = [i for i in visible if i not in coords]
    if missing:
        raise MeshBuildError(
            f"worker {worker} visible GPUs {missing} have no exported "
            "coordinate (claim env topology mismatch)")
    return {(worker, i): coords[i] for i in (visible or sorted(coords))}


def plan_from_env(env: Dict[str, str]) -> MeshPlan:
    """MeshPlan from ONE worker's claim CDI env (the workload
    container's view): GPU_VISIBLE_INDICES selects the GPUs, GPU_COORDS
    places them, GPU_FABRIC_TOPOLOGY declares the fabric. Refusals per
    _env_gpu_coords. When the env carries the claim's traceparent, the
    build lands as a ``mesh.build`` span on the claim's trace."""
    span = TRACER.begin("mesh.build", root=True,
                        traceparent=env.get(ENV_TRACEPARENT))
    ok = False
    try:
        worker = int(env.get(ENV_WORKER_INDEX, "0") or 0)
        dims = parse_topology(env.get(ENV_FABRIC_TOPOLOGY, ""))
        generation = env.get(ENV_GENERATION, "")
        plan = plan_from_coords(_env_gpu_coords(env, worker), dims,
                                generation)
        span.set(n_devices=plan.n_devices, contiguous=plan.contiguous)
        ok = True
        return plan
    finally:
        if ok:
            span.end()
        else:
            span.abandon("mesh build refused")


def plan_from_worker_envs(envs: Sequence[Dict[str, str]]) -> MeshPlan:
    """MeshPlan across a multi-process worker set: each env is one
    worker's claim CDI env merged with its domain identity
    (GPU_WORKER_ID, GPU_WORKER_HOSTNAMES). Refuses non-contiguous worker
    ids, a peer list whose size disagrees with the env count,
    conflicting topologies or generations, and overlapping coordinates."""
    if not envs:
        raise MeshBuildError("no worker envs")
    ids = []
    for env in envs:
        try:
            ids.append(int(env[ENV_WORKER_ID]))
        except (KeyError, ValueError) as e:
            raise MeshBuildError(
                f"worker env missing a parseable {ENV_WORKER_ID}") from e
    if sorted(ids) != list(range(len(envs))):
        raise MeshBuildError(
            f"worker ids {sorted(ids)} are not the contiguous range "
            f"0..{len(envs) - 1} (rank mismatch)")
    hostnames = {env.get(ENV_WORKER_HOSTNAMES, "") for env in envs}
    hostnames.discard("")
    if len(hostnames) > 1:
        raise MeshBuildError(
            f"workers disagree on the peer list: {sorted(hostnames)}")
    if hostnames:
        n_hosts = len(next(iter(hostnames)).split(","))
        if n_hosts != len(envs):
            raise MeshBuildError(
                f"peer list names {n_hosts} hosts but {len(envs)} "
                "worker envs were provided (rank/topology mismatch)")
    dims_seen = {env.get(ENV_FABRIC_TOPOLOGY, "") for env in envs}
    dims_seen.discard("")
    if len(dims_seen) > 1:
        raise MeshBuildError(
            f"workers declare conflicting fabric topologies "
            f"{sorted(dims_seen)}")
    dims = parse_topology(next(iter(dims_seen))) if dims_seen else None
    gens_seen = {env.get(ENV_GENERATION, "") for env in envs}
    gens_seen.discard("")
    if len(gens_seen) > 1:
        raise MeshBuildError(
            f"workers declare conflicting generations {sorted(gens_seen)}")
    generation = next(iter(gens_seen)) if gens_seen else ""
    span = TRACER.begin(
        "mesh.build", root=True,
        traceparent=next((e.get(ENV_TRACEPARENT) for e in envs
                          if e.get(ENV_TRACEPARENT)), None),
        attributes={"n_workers": len(envs)})
    ok = False
    try:
        merged: Dict[Tuple[int, int], Coord] = {}
        for env in envs:
            merged.update(_env_gpu_coords(env, int(env[ENV_WORKER_ID])))
        plan = plan_from_coords(merged, dims, generation,
                                n_workers=len(envs))
        ok = True
        return plan
    finally:
        if ok:
            span.end()
        else:
            span.abandon("mesh build refused")


def plan_from_allocation(claim: Dict, slices: List[Dict]) -> MeshPlan:
    """Control-plane adapter: MeshPlan straight from cluster truth (an
    allocated ResourceClaim + the nodes' published ResourceSlices),
    bypassing the CDI env."""
    results = (((claim.get("status") or {}).get("allocation") or {})
               .get("devices") or {}).get("results") or []
    if not results:
        raise MeshBuildError("claim has no allocation results")
    pools = {r.get("pool", "") for r in results}
    by_node: Dict[str, List[Dict]] = {}
    for sl in slices:
        node = (sl.get("spec") or {}).get("nodeName")
        if node in pools:
            by_node.setdefault(node, []).append(sl)
    coords: Dict[Tuple[int, int], Coord] = {}
    generation = ""
    dims: Optional[Tuple[int, int, int]] = None
    for w, pool in enumerate(sorted(pools, key=_natural_name_key)):
        topo = node_topology_from_slices(by_node.get(pool, []))
        if topo is None:
            raise MeshBuildError(
                f"node {pool} publishes no usable topology")
        devices = [r.get("device", "") for r in results
                   if r.get("pool", "") == pool]
        for i, dev in enumerate(sorted(devices, key=_natural_name_key)):
            if dev not in topo.coord_of:
                raise MeshBuildError(
                    f"allocated device {dev} carries no coordinate on "
                    f"{pool}")
            # The real GPU index where the name carries one (gpu-10
            # sorts AND keys as 10), positional otherwise.
            _head, _sep, tail = dev.rpartition("-")
            key = (w, int(tail) if tail.isdigit() else i)
            if key in coords:
                raise MeshBuildError(
                    f"devices on {pool} collide on GPU index "
                    f"{key[1]} ({dev} vs an earlier device)")
            coords[key] = topo.coord_of[dev]
        if dims is None:
            dims = topo.fabric.dims
        gen = next(((_attr_str(d, "architecture") or "")
                    for sl in by_node.get(pool, [])
                    for d in (sl.get("spec") or {}).get("devices") or []),
                   "")
        generation = generation or gen
    return plan_from_coords(coords, dims, generation,
                            n_workers=len(pools))


def _attr_str(dev: Dict, name: str) -> Optional[str]:
    a = (dev.get("attributes") or {}).get(name) or {}
    return a.get("string")


def _natural_name_key(name: str):
    """Order names with a trailing integer numerically (gpu-10 after
    gpu-2): lexicographic order would scramble ranks on a node with 10+
    GPUs."""
    head, sep, tail = name.rpartition("-")
    if sep and tail.isdigit():
        return (head, int(tail))
    return (name, -1)


def admit_launch(workload: str) -> None:
    """Launch-admission seam consulted before a workload runs on a built
    mesh (``workloads.meshbuild.launch_workload``)."""
    FAULTS.check("workload.launch", workload=workload)
