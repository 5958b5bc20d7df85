"""Devices and workloads from a driver allocation (counterpart of
tpu_dra/workloads/meshbuild.py).

A prepared claim's CDI env names the GPUs (their UUIDs in
``CUDA_VISIBLE_DEVICES``) and their NVLink coordinates; the
:class:`~tpu_dra_torch.topology.meshexport.MeshPlan` built from that env
fixes a deterministic rank order. This module maps the env's UUIDs to
the ``torch.device``s of the process that reads it
(``devices_from_env``), lays them out in the plan's order
(``ordered_devices``, ``mesh_from_plan``) and runs a workload on them
(``launch_workload``). Every launch passes the ``workload.launch``
admission seam and every plan the ``mesh.build`` one.

Registered workloads: ``"train"``, the flagship TransformerLM train step
on the plan's rank-0 device. The multi-GPU workloads (all-reduce, ring
attention, Ulysses, MoE, pipeline, sequence-parallel training) and a
``DeviceMesh`` over a process group come with the multi-GPU slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_dra_torch.topology.meshexport import (
    ENV_CUDA_VISIBLE, MeshBuildError, MeshPlan, admit_launch,
)


def ordered_devices(plan: MeshPlan, devices: Sequence) -> List:
    """Permute `devices` into the plan's rank order. `devices` is the
    arrival-order list — one device per allocated GPU, aligned with the
    plan's (worker_index, gpu_index)-sorted arrival order. Refuses a
    count mismatch: a mesh over the wrong device count is a
    rank/topology lie."""
    if len(devices) != plan.n_devices:
        raise MeshBuildError(
            f"allocation plans {plan.n_devices} devices but "
            f"{len(devices)} devices were supplied")
    return [devices[i] for i in plan.order]


@dataclass(frozen=True)
class DeviceGrid:
    """The plan-ordered devices laid out as an N-D array with its axis
    names (what a ``DeviceMesh`` is built from)."""
    devices: np.ndarray
    axis_names: tuple


def mesh_from_plan(plan: MeshPlan, devices: Sequence,
                   axis_names: Sequence[str] = ("x",),
                   shape: Optional[Sequence[int]] = None) -> DeviceGrid:
    """The plan-ordered devices as a grid. Default is the 1-D collective
    layout; pass `axis_names` + `shape` for N-D layouts (the product must
    equal the device count — checked, not truncated)."""
    devs = ordered_devices(plan, devices)
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None or len(shape) != len(axis_names):
        raise MeshBuildError(
            f"axis_names {tuple(axis_names)} need an explicit shape")
    n = 1
    for d in shape:
        n *= d
    if n != len(devs):
        raise MeshBuildError(
            f"mesh shape {tuple(shape)} holds {n} devices but the "
            f"allocation has {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return DeviceGrid(grid.reshape(tuple(shape)), tuple(axis_names))


def normalize_uuid(uuid) -> str:
    """A GPU or MIG-device UUID as NVML ("GPU-8c6b...", "MIG-1f2e...")
    and torch ("8c6b...") print it, reduced to one form for comparison:
    CUDA reports a MIG device's own UUID as the device's."""
    text = str(uuid).strip().lower()
    return text[4:] if text.startswith(("gpu-", "mig-")) else text


def devices_from_env(env: Dict[str, str], device_type: str = "cuda"
                     ) -> List[torch.device]:
    """The claim's GPUs as this process's devices, in the env's order
    (node-index order, the plan's arrival order); a MIG device's "MIG-"
    UUID names it in its GPU's place. With
    ``CUDA_VISIBLE_DEVICES`` applied before CUDA initialised, the
    process's i-th CUDA device is the env's i-th UUID; each is checked
    against the device's own UUID. ``device_type="cpu"`` stands one CPU
    device in for each GPU, for the CPU tier."""
    uuids = [u.strip() for u in env.get(ENV_CUDA_VISIBLE, "").split(",")
             if u.strip()]
    if not uuids:
        raise MeshBuildError(f"claim env names no GPUs in {ENV_CUDA_VISIBLE}")
    if device_type == "cpu":
        return [torch.device("cpu")] * len(uuids)
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if n != len(uuids):
        raise MeshBuildError(
            f"the claim env names {len(uuids)} GPUs but this process sees "
            f"{n} (was CUDA initialised before the env was applied?)")
    out = []
    for i, uuid in enumerate(uuids):
        seen = normalize_uuid(torch.cuda.get_device_properties(i).uuid)
        if seen != normalize_uuid(uuid):
            raise MeshBuildError(
                f"cuda:{i} is GPU {seen}, the claim env's GPU {i} is {uuid}")
        out.append(torch.device("cuda", i))
    return out


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

def _run_train(plan: MeshPlan, devices: Sequence, *, cfg=None,
               steps: int = 3, params=None, tokens=None,
               lr: float = 1e-3, warm_steps: int = 0,
               barrier: Optional[Callable[[], None]] = None) -> Dict:
    """`steps` SGD steps of the TransformerLM (the flagship config by
    default; weights from seed 0 and tokens of the flagship batch from
    numpy RandomState(0) unless `params` and `tokens` are given) on the
    plan's rank-0 device, after `warm_steps` untimed ones and then
    `barrier()` (a tenant of a shared claim waits there for the others).
    Returns every timed step's loss and wall time (each step ends in a
    loss fetch, which synchronizes the device) and the host-clock window
    (time.time() at the first step's start and the last one's end)."""
    from tpu_dra_torch import bench
    from tpu_dra_torch.workloads.model import (
        TransformerLM, init_params, make_train_step,
    )

    device = ordered_devices(plan, devices)[0]
    cfg = cfg or bench.FLAGSHIP
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
    model = TransformerLM(cfg, params)
    if tokens is None:
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab, (bench.FLAGSHIP_BATCH, cfg.max_seq))
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
    step = make_train_step(model, lr=lr)
    for _ in range(warm_steps):
        float(step(tokens))
    if barrier is not None:
        barrier()
    losses, times = [], []
    window_start = time.time()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        times.append(time.perf_counter() - t0)
    return {"workload": "train", "losses": losses, "loss": losses[-1],
            "step_times_s": times, "steps": steps, "device": str(device),
            "window": [window_start, time.time()],
            "n_devices": plan.n_devices, "n_layers": cfg.n_layers,
            "batch": int(tokens.shape[0]), "seq": int(tokens.shape[1])}


WORKLOADS: Dict[str, Callable] = {
    "train": _run_train,
}


def launch_workload(name: str, plan: MeshPlan, devices: Sequence,
                    **kw) -> Dict:
    """Run workload `name` on the allocation's devices and return its
    record. Unknown names refuse; the workload.launch admission seam
    runs first."""
    if name not in WORKLOADS:
        raise MeshBuildError(
            f"unknown workload {name!r} (known: {sorted(WORKLOADS)})")
    admit_launch(name)
    return WORKLOADS[name](plan, devices, **kw)
