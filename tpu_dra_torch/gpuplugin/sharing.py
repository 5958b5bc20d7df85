"""GPU sharing: time-slicing (counterpart of TimeSlicingManager in
tpu_dra/tpuplugin/sharing.py).

``TimeSlicingManager`` programs each GPU's compute time slice through the
backend (``nvidia-smi compute-policy --set-timeslice`` on a real node) and
drops exclusive compute mode, since time-slicing implies shared access.
MPS (the reference's MultiprocessManager, with its per-claim control
daemon) comes with the native helpers; DeviceState refuses an MPS config
until then.
"""

from __future__ import annotations

from typing import List

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.native.gpuinfo import Gpu, GpuInfoBackend


class TimeSlicingManager:
    """Programs per-GPU time-slice levels."""

    def __init__(self, backend: GpuInfoBackend):
        self._backend = backend

    def set_timeslice(self, gpus: List[Gpu],
                      config: apitypes.TimeSlicingConfig) -> None:
        level = config.level()
        for gpu in gpus:
            self._backend.set_timeslice(gpu.index, level)
            # Time-slicing implies shared access: drop exclusive mode
            # (compute mode DEFAULT).
            self._backend.set_exclusive_mode(gpu.index, False)

    def reset(self, gpus: List[Gpu]) -> None:
        self.set_timeslice(gpus, apitypes.TimeSlicingConfig("Default"))
