"""Allocatable device model: whole GPUs and MIG devices (counterpart of
tpu_dra/tpuplugin/deviceinfo.py).

``AllocatableDevice`` is a tagged union, ``gpu | mig``, rendered into a
``resourceapi.Device`` with CEL-selectable attributes and capacity.

- ``gpu`` — a whole GPU (``/dev/nvidiaN``), the reference's chip.
- ``mig`` — a placement of a GPU-instance profile on a GPU in MIG mode,
  the reference's subslice. Unlike a subslice a MIG device is hardware
  state: prepare creates the GPU instance at the placement (and its
  full-size compute instance), unprepare destroys it. As the reference
  advertises every subslice placement, every possible placement of every
  profile is advertised; the scheduler picks one, and DeviceState refuses
  one whose memory slices overlap an instance another claim holds.

Device names are DNS labels: ``gpu-3``, ``gpu-3-mig-3g40gb-4`` (GPU 3,
profile 3g.40gb, at memory slice 4; a DNS label has no dot, so the
profile's dot is dropped from the name and kept in the ``profile``
attribute). Passthrough is a prepare-time mode on a GPU
(PassthroughConfig), not a distinct advertised device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tpu_dra_torch.native.gpuinfo import Gpu, MigProfile

DEVICE_TYPE_GPU = "gpu"
DEVICE_TYPE_MIG = "mig"
# Memory slices per GPU: MIG profiles count memory in eighths.
MIG_MEMORY_SLICES = 8


@dataclass(frozen=True)
class MigPlacement:
    """One placement of a GPU-instance profile on a GPU: memory slices
    [start, start + size)."""
    gpu: Gpu
    profile: str
    start: int
    size: int
    memory_bytes: int

    @property
    def name(self) -> str:
        return (f"gpu-{self.gpu.index}-mig-{self.profile.replace('.', '')}"
                f"-{self.start}")

    @property
    def slices(self) -> range:
        return range(self.start, self.start + self.size)


def mig_placements(gpu: Gpu, profiles: List[MigProfile]
                   ) -> List[MigPlacement]:
    """Every possible placement of every profile in `profiles` (the GPU's,
    as its backend's mig_profiles reads them), by profile then start."""
    return [MigPlacement(gpu=gpu, profile=p.name, start=s,
                         size=p.memory_slices, memory_bytes=p.memory_bytes)
            for p in profiles for s in p.starts]


def gpu_device_name(gpu: Gpu) -> str:
    return f"gpu-{gpu.index}"


@dataclass(frozen=True)
class AllocatableDevice:
    """One allocatable device of the node: a whole GPU or a MIG device."""
    type: str
    gpu: Gpu
    mig: Optional[MigPlacement] = None

    @property
    def name(self) -> str:
        if self.type == DEVICE_TYPE_MIG:
            return self.mig.name
        return gpu_device_name(self.gpu)

    def to_resource_api(self) -> Dict:
        """The resourceapi.Device entry for the ResourceSlice. Attribute
        names sit under the driver's implicit prefix; a DeviceClass CEL
        selects on e.g. device.attributes['gpu.dev'].productName."""
        g = self.gpu
        major, minor = g.compute_capability
        attrs: Dict[str, Dict] = {
            "type": {"string": self.type},
            "uuid": {"string": g.uuid},
            "productName": {"string": g.product_name},
            "index": {"int": g.index},
            "minor": {"int": g.minor},
            "pciBusID": {"string": g.pci_bus_id},
            "cudaComputeCapability": {"version": f"{major}.{minor}.0"},
            "architecture": {"string": g.generation},
            "clique": {"string": g.clique_id},
            "workerIndex": {"int": g.worker_index},
            "coordX": {"int": g.coords[0]},
            "coordY": {"int": g.coords[1]},
            "coordZ": {"int": g.coords[2]},
            # Declared dims of the GPU's NVLink domain ("8x1x1").
            "fabricTopology": {"string": g.slice_topology},
        }
        if self.type == DEVICE_TYPE_GPU:
            capacity = {"memory": {"value": str(g.memory_bytes)}}
        else:
            m = self.mig
            attrs["parentUUID"] = {"string": g.uuid}
            attrs["profile"] = {"string": m.profile}
            attrs["placementStart"] = {"int": m.start}
            capacity = {"memory": {"value": str(m.memory_bytes)}}
        return {"name": self.name, "attributes": attrs, "capacity": capacity}


def enumerate_allocatable(
        gpus: List[Gpu], include_mig: bool = True,
        mig_profiles: Optional[Callable[[int], List[MigProfile]]] = None
) -> Dict[str, AllocatableDevice]:
    """All allocatable devices on this node, keyed by device name: each
    GPU, and under `include_mig` every MIG placement of each GPU whose
    MIG mode is on, from `mig_profiles(gpu_index)`."""
    out: Dict[str, AllocatableDevice] = {}
    for gpu in gpus:
        dev = AllocatableDevice(type=DEVICE_TYPE_GPU, gpu=gpu)
        out[dev.name] = dev
        if include_mig and gpu.mig_mode and mig_profiles is not None:
            for p in mig_placements(gpu, mig_profiles(gpu.index)):
                dev = AllocatableDevice(type=DEVICE_TYPE_MIG, gpu=gpu, mig=p)
                out[dev.name] = dev
    return out
