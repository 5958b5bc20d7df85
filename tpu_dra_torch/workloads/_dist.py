"""The port's seam to the runtime's collectives: process groups, meshes of
process groups, differentiable collectives and a pool of rank processes.

The reference needs none of this: JAX runs one controller over a
``jax.sharding.Mesh`` and XLA inserts the collectives (its
``_compat.shard_map`` and ``jax.lax``'s psum, all_to_all and ppermute).
PyTorch runs one process per device, so each workload runs as SPMD code
over a ``torch.distributed`` process group:

- ``start_group`` starts this process's group (``nccl`` for CUDA devices,
  ``gloo`` for CPU ones) on a store the caller names: an in-process
  ``HashStore`` at world 1, a ``FileStore`` in a private temporary
  directory for spawned ranks, or — for the ranks of a ComputeDomain —
  a ``TCPStore`` at the rendezvous its channel claim's env names
  (``MASTER_ADDR``/``MASTER_PORT``; ``domain_rank`` derives RANK and
  WORLD_SIZE from the env's ``NODE_RANK``/``NNODES`` and the node's
  GPUs, and ``start_domain_group`` starts the group there and checks
  with ``psum_of_ranks`` that the ranks met as themselves). One all-reduce
  of a one-element tensor checks the group before anything runs on it.
- ``Mesh`` is this rank's view of a device grid (``meshbuild.DeviceGrid``,
  laid out in the plan's rank order): rank r sits at grid position r in
  row-major order and holds one process group per mesh axis of size > 1
  (``data``, ``model``, ``seq``, ``expert``, ``stage``).
- The collectives are differentiable: ``all_reduce`` (the psum: a sum
  forward and backward) and ``all_to_all`` (tiled on a split and a
  concat axis; its backward is the inverse all-to-all) over
  ``torch.distributed.nn.functional``, and the port's own
  ``torch.autograd.Function``s for what that module lacks: the
  tensor-parallel pair ``copy_to`` (identity forward, sum backward) and
  ``reduce_from`` (sum forward, identity backward), and ``rotate``
  (ppermute by a shift around the axis; its backward rotates the other
  way). Over a group of one each is the identity, as XLA compiles a
  one-device collective away.
- ``RankPool`` spawns one process per device, each with its group up,
  and runs module-level functions on all of them at once.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

# How long a collective may wait for its peers before the group gives up
# (a rank that raised leaves the others waiting).
GROUP_TIMEOUT_S = 300.0


def backend_for(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def start_group(rank: int, world: int, device, store) -> None:
    """Start this process's default group as rank `rank` of `world` on
    `store`, pinned to `device`, and check it with one all-reduce. A
    group that cannot start raises; nothing drops to another backend."""
    device = torch.device(device)
    backend = backend_for(device)
    kw = {}
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if float(probe) != world:
        raise RuntimeError(f"{backend} group check summed {float(probe)} "
                           f"over {world} ranks")


def start_local_group(device) -> None:
    """A world-1 group in this process, on an in-process store."""
    start_group(0, 1, device, dist.HashStore())


def domain_rank(env: Dict[str, str], local_index: int,
                n_local: int) -> tuple:
    """(RANK, WORLD_SIZE) of the `local_index`-th of the `n_local` GPUs
    of a node whose ComputeDomain channel-claim env is `env`: the node's
    NODE_RANK places its GPUs' ranks after those of the nodes before it,
    and the domain's NNODES nodes each hold `n_local` GPUs (a node knows
    only its own count; start_domain_group holds the nodes to one)."""
    try:
        node_rank, n_nodes = int(env["NODE_RANK"]), int(env["NNODES"])
    except (KeyError, ValueError) as e:
        raise ValueError("the env names no parseable NODE_RANK and NNODES "
                         "of a ComputeDomain channel claim") from e
    if not 0 <= local_index < n_local or not 0 <= node_rank < n_nodes:
        raise ValueError(f"GPU {local_index} of {n_local} on node "
                         f"{node_rank} of {n_nodes}")
    return node_rank * n_local + local_index, n_nodes * n_local


# This process's place in a ComputeDomain's group while one is up.
_DOMAIN: Optional[Dict] = None


def start_domain_group(env: Dict[str, str], device, local_index: int = 0,
                       n_local: int = 1) -> Dict:
    """Start this process's group as the rank domain_rank gives it, on the
    domain's rendezvous: a TCPStore at MASTER_ADDR:MASTER_PORT, served by
    rank 0 and joined by the others. Rank 0 publishes its world size and
    every other rank refuses to join a different one (its node holds
    another GPU count). Once the group is up, psum_of_ranks must read
    n(n+1)/2. Returns this rank's place (domain_place() until the group
    stops): rank, world, node_rank, rendezvous and the psum."""
    global _DOMAIN
    rank, world = domain_rank(env, local_index, n_local)
    try:
        addr, port = env["MASTER_ADDR"], int(env["MASTER_PORT"])
    except (KeyError, ValueError) as e:
        raise ValueError("the env names no MASTER_ADDR and MASTER_PORT of "
                         "a ComputeDomain channel claim") from e
    store = dist.TCPStore(addr, port, world, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                          wait_for_workers=False)
    if rank == 0:
        store.set("domain/world", str(world))
    else:
        served = int(store.get("domain/world"))
        if served != world:
            raise RuntimeError(
                f"rank {rank}: this node's {n_local} GPUs make a world of "
                f"{world}, rank 0's node serves one of {served}")
    start_group(rank, world, device, store)
    psum = psum_of_ranks()
    if psum != world * (world + 1) / 2:
        stop_group()
        raise RuntimeError(f"the domain's ranks summed {psum}, not "
                           f"{world * (world + 1) / 2}: two took one rank")
    _DOMAIN = {"rank": rank, "world": world,
               "node_rank": int(env["NODE_RANK"]),
               "rendezvous": f"{addr}:{port}", "psum": psum}
    return dict(_DOMAIN)


def domain_place() -> Optional[Dict]:
    """What start_domain_group returned, while its group is up; else
    None."""
    return None if _DOMAIN is None else dict(_DOMAIN)


def psum_of_ranks() -> float:
    """Every rank of the default group contributes rank + 1 and reads the
    group's sum, n(n+1)/2: a check that the ranks met as the ranks they
    take themselves for."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.tensor([float(dist.get_rank() + 1)], device=device)
    dist.all_reduce(x)
    return float(x[0])


def stop_group() -> None:
    global _DOMAIN
    _DOMAIN = None
    if dist.is_initialized():
        dist.destroy_process_group()


def is_up() -> bool:
    return dist.is_available() and dist.is_initialized()


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's view of a device grid: the grid's axis names and shape,
    this rank's coordinates and device, and one process group per axis
    of size > 1 (the ranks that differ from this one only along that
    axis). Every rank of the default group must build the same mesh in
    the same order: each group is made collectively."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        shape = tuple(devices.shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"grid of shape {shape} with axis names "
                             f"{tuple(axis_names)}")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"grid {shape} holds {int(np.prod(shape))} "
                             f"devices; the process group has {world} ranks")
        self.rank = dist.get_rank()
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        coords = np.unravel_index(self.rank, shape)
        self.coords = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self.device = torch.device(devices.flat[self.rank])
        ranks = np.arange(world).reshape(shape)
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, axis in enumerate(self.axis_names):
            self.groups[axis] = None
            if shape[i] == 1:
                continue
            for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[axis] = group

    @classmethod
    def from_grid(cls, grid) -> "Mesh":
        """The mesh of a ``meshbuild.DeviceGrid``."""
        return cls(grid.devices, grid.axis_names)

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The axis's group; None for an axis of size 1 (or absent)."""
        return self.groups.get(axis)


def axis_of(mesh: Optional[Mesh], axis: str):
    """(group, size, index) of `axis`; a missing mesh is one device."""
    if mesh is None or not axis:
        return None, 1, 0
    return mesh.group(axis), mesh.size(axis), mesh.index(axis)


def shard(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
          dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim`, split evenly over `axis`."""
    _, n, i = axis_of(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"by the {axis!r} axis' {n} ranks")
    return x.chunk(n, dim=dim)[i] if n > 1 else x


# ---------------------------------------------------------------------------
# Collectives (identity over a group of one)
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    """The group's size; None stands for a group of one."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """psum: the sum over the group, whose gradient is the sum of the
    ranks' gradients (the transpose of psum)."""
    return x if group_size(group) == 1 else dist_nn.all_reduce(x, group=group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor-parallel region: `x` is the same on every rank, its
    gradient is the sum of the ranks' (each rank's sees only the columns
    it holds)."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a tensor-parallel region: the sum of the ranks' partials,
    consumed alike on every rank, so each rank's gradient is the
    output's."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all (jax.lax.all_to_all(..., tiled=True)): `x` split
    into the group's size of blocks along `split_axis`, block j sent to
    rank j, the received blocks concatenated along `concat_axis` in rank
    order."""
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis {split_axis} of {tuple(x.shape)} "
                         f"does not divide by {n} ranks")
    if n == 1:
        return x
    chunks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = dist_nn.all_to_all_single(torch.empty_like(chunks), chunks,
                                    group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = group_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, dy):
        return _rotate(dy, ctx.group, -ctx.shift), None, None


def rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """ppermute around the group: rank i sends `x` to rank i + shift and
    returns what rank i - shift sent (mod the size). Over one rank it is
    the identity, as the reference's [(0, 0)] permutation is: a process
    cannot send to itself."""
    if group_size(group) == 1:
        return x
    return _Rotate.apply(x, group, shift)


def barrier(device) -> None:
    """A device synchronize on a CUDA device, then a barrier over the
    default group (when one is up)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if is_up() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

def _send(conn, obj) -> None:
    """Pickled by value: a Connection's own pickler would hand tensors
    over as shared memory, which every rank would then update."""
    conn.send_bytes(pickle.dumps(obj))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


def _pool_worker(rank: int, world: int, store_path: str, device: str,
                 conn, domain=None) -> None:
    torch.set_num_threads(1)
    try:
        if domain is None:
            start_group(rank, world, device,
                        dist.FileStore(store_path, world))
        else:
            start_domain_group(domain, device, rank, world)
    except Exception:  # noqa: BLE001 — reported to the parent
        _send(conn, ("err", traceback.format_exc()))
        return
    _send(conn, ("ok", None))
    try:
        while True:
            task = _recv(conn)
            if task is None:
                break
            fn, args, kw = task
            try:
                _send(conn, ("ok", fn(*args, **kw)))
            except Exception:  # noqa: BLE001 — reported to the parent
                _send(conn, ("err", traceback.format_exc()))
    finally:
        stop_group()


class RankPool:
    """One spawned process per device of `devices` (rank r on
    devices[r]), each with the default group up over all of them, ready
    to run module-level functions: ``run(fn, *args)`` calls fn on every
    rank at once and returns the ranks' results in rank order. A rank
    that raises, or a run past `timeout_s`, ends the pool and raises
    with the rank's traceback. Use as a context manager.

    With `domain` (the ComputeDomain channel-claim env of the node whose
    GPUs `devices` are) the pool's ranks are that node's: pool rank i
    takes the domain rank of the node's i-th GPU (start_domain_group)
    and meets the other nodes' ranks at the env's TCPStore instead of a
    private FileStore."""

    def __init__(self, devices: Sequence, timeout_s: float = 600.0,
                 domain: Optional[Dict[str, str]] = None):
        self.devices = [str(torch.device(d)) for d in devices]
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="rankpool_")
        ctx = multiprocessing.get_context("spawn")
        self._procs, self._conns = [], []
        world = len(self.devices)
        try:
            for rank, device in enumerate(self.devices):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_pool_worker, daemon=True,
                    args=(rank, world, os.path.join(self._dir, "store"),
                          device, child, domain))
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            self._collect()
        except BaseException:
            self.close(abort=True)
            raise

    def _collect(self) -> List:
        out: Dict[int, object] = {}
        pending = dict(enumerate(self._conns))
        while pending:
            ready = multiprocessing.connection.wait(list(pending.values()),
                                                    self.timeout_s)
            if not ready:
                self.close(abort=True)
                raise TimeoutError(f"ranks {sorted(pending)} did not answer "
                                   f"within {self.timeout_s} s")
            for rank, conn in list(pending.items()):
                if conn not in ready:
                    continue
                try:
                    status, value = _recv(conn)
                except EOFError:
                    status, value = "err", "the rank's process ended"
                if status == "err":
                    self.close(abort=True)
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
                del pending[rank]
        return [out[r] for r in range(len(self._conns))]

    def run(self, fn: Callable, *args, **kw) -> List:
        if not self._procs:
            raise RuntimeError("the pool is closed")
        for conn in self._conns:
            _send(conn, (fn, args, kw))
        return self._collect()

    def close(self, abort: bool = False) -> None:
        """Stop every rank: each leaves its loop and its group, or with
        `abort` (a rank failed, so the others may wait in a collective
        for it) is terminated at once."""
        for conn in self._conns:
            try:
                _send(conn, None)
            except (OSError, BrokenPipeError):
                pass
        for proc in self._procs:
            if not abort:
                proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
