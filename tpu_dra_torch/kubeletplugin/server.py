"""Kubelet-facing prepare results (counterpart of the dataclasses in
tpu_dra/kubeletplugin/server.py). The gRPC server and its transports come
with the driver's entry point."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class PreparedDevice:
    """One device result returned to kubelet (dra.v1 Device)."""
    pool_name: str
    device_name: str
    cdi_device_ids: List[str] = field(default_factory=list)
    request_names: List[str] = field(default_factory=list)


@dataclass
class PrepareResult:
    devices: List[PreparedDevice] = field(default_factory=list)
    error: str = ""


@dataclass
class Claim:
    uid: str
    name: str
    namespace: str
