"""Allocatable device model: whole GPUs (counterpart of
tpu_dra/tpuplugin/deviceinfo.py).

``AllocatableDevice`` renders one GPU into a ``resourceapi.Device`` with
CEL-selectable attributes and capacity. Device names are DNS-label safe:
``gpu-3``. MIG devices (the reference's subslice placements) come with
the MIG device model: enabling MIG needs root and a GPU reset.
Passthrough is a prepare-time mode on a GPU (PassthroughConfig), not a
distinct advertised device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from tpu_dra_torch.native.gpuinfo import Gpu

DEVICE_TYPE_GPU = "gpu"


def gpu_device_name(gpu: Gpu) -> str:
    return f"gpu-{gpu.index}"


@dataclass(frozen=True)
class AllocatableDevice:
    """One allocatable device of the node: a whole GPU."""
    type: str
    gpu: Gpu

    @property
    def name(self) -> str:
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
        capacity = {"memory": {"value": str(g.memory_bytes)}}
        return {"name": self.name, "attributes": attrs, "capacity": capacity}


def enumerate_allocatable(gpus: List[Gpu]) -> Dict[str, AllocatableDevice]:
    """All allocatable devices on this node, keyed by device name."""
    out: Dict[str, AllocatableDevice] = {}
    for gpu in gpus:
        dev = AllocatableDevice(type=DEVICE_TYPE_GPU, gpu=gpu)
        out[dev.name] = dev
    return out
