"""API group ``resource.gpu.dev/v1beta1``: the opaque config kinds of the
GPU driver (counterpart of tpu_dra/api/types.py).

The TPU reference's kinds map back onto their GPU originals:

- ``TpuConfig``         -> ``GpuConfig``        (a whole GPU)
- ``SubsliceConfig``    -> ``MigDeviceConfig``  (a MIG device of a GPU)
- ``PassthroughConfig`` -> ``PassthroughConfig`` (whole-GPU VFIO marker)
- sharing ``TimeSlicing`` stays; ``Multiprocess`` becomes ``MPS`` with the
  MPS control daemon's knobs (active-thread percentage, pinned device
  memory limits).

The compute-domain kinds keep the reference's shape:
``ComputeDomainChannelConfig`` and ``ComputeDomainDaemonConfig`` carry
the domain UID (and allocation mode) from the controller-stamped
ResourceClaimTemplates into the node-side prepare, and the
``ComputeDomain`` CRD's per-node ``sliceID`` becomes ``cliqueID``, the
NVLink clique (the fabric's cluster UUID and clique id): nodes with one
cliqueID share an NVLink domain, and an empty cliqueID marks a member
that reaches its peers over the network only.

Every type implements ``normalize()``/``validate()`` and
``from_dict(strict=...)``/``to_dict()``, and is registered with the
scheme in ``tpu_dra_torch.api.scheme``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.quantity import Quantity

GROUP = "resource.gpu.dev"
VERSION = "v1beta1"
API_VERSION = f"{GROUP}/{VERSION}"

# The DRA driver names (the reference's tpu.dev and
# compute-domain.tpu.dev).
GPU_DRIVER_NAME = "gpu.dev"
COMPUTE_DOMAIN_DRIVER_NAME = "compute-domain.gpu.dev"

# ComputeDomain orchestration constants shared by the controller, the
# domain daemon and the CD kubelet plugin: the node label that summons a
# domain's daemon pod, the CD finalizer and the two device classes.
COMPUTE_DOMAIN_LABEL_KEY = "resource.gpu.dev/computeDomain"
COMPUTE_DOMAIN_FINALIZER = "resource.gpu.dev/computeDomain"
DEVICE_CLASS_DAEMON = "compute-domain-daemon.gpu.dev"
DEVICE_CLASS_CHANNEL = "compute-domain-default-channel.gpu.dev"

GPU_CONFIG_KIND = "GpuConfig"
MIG_DEVICE_CONFIG_KIND = "MigDeviceConfig"
PASSTHROUGH_CONFIG_KIND = "PassthroughConfig"
COMPUTE_DOMAIN_CHANNEL_CONFIG_KIND = "ComputeDomainChannelConfig"
COMPUTE_DOMAIN_DAEMON_CONFIG_KIND = "ComputeDomainDaemonConfig"
COMPUTE_DOMAIN_KIND = "ComputeDomain"

COMPUTE_DOMAIN_STATUS_READY = "Ready"
COMPUTE_DOMAIN_STATUS_NOT_READY = "NotReady"
# A domain that WAS Ready and lost a member (node death, daemon crash):
# its workloads read a regression with status.statusReason, not a domain
# that never started. Recovery republishes Ready.
COMPUTE_DOMAIN_STATUS_DEGRADED = "Degraded"
ALLOCATION_MODE_SINGLE = "Single"
ALLOCATION_MODE_ALL = "All"

# Sharing strategies.
TimeSlicingStrategy = "TimeSlicing"
MpsStrategy = "MPS"

# Time-slice intervals: the level `nvidia-smi compute-policy
# --set-timeslice` takes (0 resets to the driver default). Single source
# of truth — the time-slicing manager indexes this same map.
TIME_SLICE_INTERVALS = {"Default": 0, "Short": 1, "Medium": 2, "Long": 3}
DEFAULT_TIME_SLICE = "Default"


class ValidationError(ValueError):
    pass


def _unknown_fields(data: Dict[str, Any], allowed: set, strict: bool, path: str):
    _require_type(data, dict, path)
    if not strict:
        return
    unknown = set(data) - allowed
    if unknown:
        raise ValidationError(
            f"strict decoding error: unknown field(s) {sorted(unknown)} in {path}")


def _require_type(val, typ, path: str):
    if not isinstance(val, typ):
        raise ValidationError(f"{path}: expected {typ.__name__}, got {type(val).__name__}")
    return val


# ---------------------------------------------------------------------------
# Sharing
# ---------------------------------------------------------------------------

@dataclass
class TimeSlicingConfig:
    """Per-GPU compute time-slice length."""
    interval: str = DEFAULT_TIME_SLICE

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "timeSlicingConfig"):
        _unknown_fields(data, {"interval"}, strict, path)
        return cls(interval=data.get("interval", DEFAULT_TIME_SLICE))

    def to_dict(self) -> Dict[str, Any]:
        return {"interval": self.interval}

    def validate(self):
        if self.interval not in TIME_SLICE_INTERVALS:
            raise ValidationError(
                f"unknown time-slice interval: {self.interval!r} "
                f"(must be one of {sorted(TIME_SLICE_INTERVALS)})")

    def level(self) -> int:
        return TIME_SLICE_INTERVALS[self.interval]


@dataclass
class MpsPerDevicePinnedMemoryLimit:
    """Map of device selector -> pinned device-memory limit for one MPS
    tenant. Keys are GPU UUIDs, GPU indices (stringified ints), or
    ``"default"``; values are k8s quantities."""
    limits: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str):
        _require_type(data, dict, path)
        return cls(limits=dict(data))

    def to_dict(self) -> Dict[str, str]:
        return dict(self.limits)

    def validate(self):
        for key, raw in self.limits.items():
            try:
                Quantity(raw)
            except ValueError as e:
                raise ValidationError(
                    f"defaultPerDevicePinnedMemoryLimit[{key}]: {e}") from e

    def normalize(self, uuids: List[str], indices: Dict[str, int],
                  default_limit: Optional[str]) -> Dict[str, int]:
        """{uuid: bytes} for the claim's GPUs: index keys become UUIDs,
        "default" (else the config-level default) fills every GPU not
        named, and a key naming a GPU outside the claim is refused."""
        resolved: Dict[str, int] = {}
        default = self.limits.get("default", default_limit)
        if default is not None:
            for uuid in uuids:
                resolved[uuid] = Quantity(default).value
        index_to_uuid = {str(i): u for u, i in indices.items()}
        for key, raw in self.limits.items():
            if key == "default":
                continue
            uuid = index_to_uuid.get(key, key)
            if uuid not in uuids:
                raise ValidationError(
                    f"defaultPerDevicePinnedMemoryLimit: device {key!r} is "
                    "not part of this claim")
            resolved[uuid] = Quantity(raw).value
        return resolved


@dataclass
class MpsConfig:
    """MPS control-daemon settings for the claim's GPUs: the active
    thread percentage and pinned device-memory limits."""
    default_active_thread_percentage: Optional[int] = None
    default_pinned_device_memory_limit: Optional[str] = None
    per_device_pinned_memory_limit: Optional[MpsPerDevicePinnedMemoryLimit] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "mpsConfig"):
        allowed = {"defaultActiveThreadPercentage",
                   "defaultPinnedDeviceMemoryLimit",
                   "defaultPerDevicePinnedMemoryLimit"}
        _unknown_fields(data, allowed, strict, path)
        per_dev = None
        if "defaultPerDevicePinnedMemoryLimit" in data:
            per_dev = MpsPerDevicePinnedMemoryLimit.from_dict(
                data["defaultPerDevicePinnedMemoryLimit"], strict,
                f"{path}.defaultPerDevicePinnedMemoryLimit")
        return cls(
            default_active_thread_percentage=data.get(
                "defaultActiveThreadPercentage"),
            default_pinned_device_memory_limit=data.get(
                "defaultPinnedDeviceMemoryLimit"),
            per_device_pinned_memory_limit=per_dev,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.default_active_thread_percentage is not None:
            out["defaultActiveThreadPercentage"] = \
                self.default_active_thread_percentage
        if self.default_pinned_device_memory_limit is not None:
            out["defaultPinnedDeviceMemoryLimit"] = \
                self.default_pinned_device_memory_limit
        if self.per_device_pinned_memory_limit is not None:
            out["defaultPerDevicePinnedMemoryLimit"] = \
                self.per_device_pinned_memory_limit.to_dict()
        return out

    def validate(self):
        pct = self.default_active_thread_percentage
        if pct is not None and not (0 < pct <= 100):
            raise ValidationError(
                f"defaultActiveThreadPercentage must be in (0, 100], got {pct}")
        if self.default_pinned_device_memory_limit is not None:
            try:
                Quantity(self.default_pinned_device_memory_limit)
            except ValueError as e:
                raise ValidationError(
                    f"defaultPinnedDeviceMemoryLimit: {e}") from e
        if self.per_device_pinned_memory_limit is not None:
            self.per_device_pinned_memory_limit.validate()


@dataclass
class GpuSharing:
    """Sharing strategy selector."""
    strategy: str = TimeSlicingStrategy
    time_slicing_config: Optional[TimeSlicingConfig] = None
    mps_config: Optional[MpsConfig] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "sharing"):
        allowed = {"strategy", "timeSlicingConfig", "mpsConfig"}
        _unknown_fields(data, allowed, strict, path)
        ts = mps = None
        if "timeSlicingConfig" in data and data["timeSlicingConfig"] is not None:
            ts = TimeSlicingConfig.from_dict(
                data["timeSlicingConfig"], strict, f"{path}.timeSlicingConfig")
        if "mpsConfig" in data and data["mpsConfig"] is not None:
            mps = MpsConfig.from_dict(data["mpsConfig"], strict,
                                      f"{path}.mpsConfig")
        return cls(strategy=data.get("strategy", ""), time_slicing_config=ts,
                   mps_config=mps)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"strategy": self.strategy}
        if self.time_slicing_config is not None:
            out["timeSlicingConfig"] = self.time_slicing_config.to_dict()
        if self.mps_config is not None:
            out["mpsConfig"] = self.mps_config.to_dict()
        return out

    def validate(self):
        """Gate-aware validation: a strategy is only valid while its
        feature gate is enabled (TimeSlicingSettings, and
        MultiprocessSupport for MPS) — a gated-off strategy is
        'unknown'."""
        if (self.strategy == TimeSlicingStrategy
                and featuregates.enabled(featuregates.TimeSlicingSettings)):
            if self.mps_config is not None:
                raise ValidationError("mpsConfig set with TimeSlicing strategy")
            if self.time_slicing_config is not None:
                self.time_slicing_config.validate()
        elif (self.strategy == MpsStrategy
                and featuregates.enabled(featuregates.MultiprocessSupport)):
            if self.time_slicing_config is not None:
                raise ValidationError("timeSlicingConfig set with MPS strategy")
            if self.mps_config is not None:
                self.mps_config.validate()
        else:
            raise ValidationError(
                f"unknown GPU sharing strategy: {self.strategy!r} "
                "(is its feature gate enabled?)")

    def is_time_slicing(self) -> bool:
        return self.strategy == TimeSlicingStrategy

    def is_mps(self) -> bool:
        return self.strategy == MpsStrategy


# ---------------------------------------------------------------------------
# Opaque config kinds
# ---------------------------------------------------------------------------

class _ConfigBase:
    KIND = ""

    def type_meta(self) -> Dict[str, str]:
        return {"apiVersion": API_VERSION, "kind": self.KIND}


@dataclass
class _SharingConfigBase(_ConfigBase):
    """Shared machinery for the two sharing-carrying config kinds."""
    sharing: Optional[GpuSharing] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True):
        _unknown_fields(data, {"apiVersion", "kind", "sharing"}, strict, self_path(cls))
        sharing = None
        if data.get("sharing") is not None:
            sharing = GpuSharing.from_dict(data["sharing"], strict, "sharing")
        return cls(sharing=sharing)

    def to_dict(self) -> Dict[str, Any]:
        out = self.type_meta()
        if self.sharing is not None:
            out["sharing"] = self.sharing.to_dict()
        return out

    def normalize(self):
        """Fill implied defaults."""
        if self.sharing is None:
            if not featuregates.enabled(featuregates.TimeSlicingSettings):
                return
            self.sharing = GpuSharing(strategy=TimeSlicingStrategy)
        if featuregates.enabled(featuregates.TimeSlicingSettings):
            if (self.sharing.strategy == TimeSlicingStrategy
                    and self.sharing.time_slicing_config is None):
                self.sharing.time_slicing_config = TimeSlicingConfig(DEFAULT_TIME_SLICE)
        if featuregates.enabled(featuregates.MultiprocessSupport):
            if (self.sharing.strategy == MpsStrategy
                    and self.sharing.mps_config is None):
                self.sharing.mps_config = MpsConfig()

    def validate(self):
        if self.sharing is not None:
            self.sharing.validate()


@dataclass
class GpuConfig(_SharingConfigBase):
    """Per-claim config for a whole GPU."""
    KIND = GPU_CONFIG_KIND

    @classmethod
    def default(cls) -> "GpuConfig":
        cfg = cls()
        if featuregates.enabled(featuregates.TimeSlicingSettings):
            cfg.sharing = GpuSharing(
                strategy=TimeSlicingStrategy,
                time_slicing_config=TimeSlicingConfig(interval=DEFAULT_TIME_SLICE))
        return cfg


@dataclass
class MigDeviceConfig(_SharingConfigBase):
    """Per-claim config for a MIG device of a GPU. The MIG profile and
    placement are chosen by the scheduler through device selection; this
    config carries only sharing settings for it. A MIG device's compute
    instance is time-sliced among its processes by the driver, with no
    setting of its own, so the only strategy it takes is TimeSlicing
    without a timeSlicingConfig, and nothing is implied by default."""
    KIND = MIG_DEVICE_CONFIG_KIND

    def normalize(self):
        pass

    def validate(self):
        if self.sharing is None:
            return
        self.sharing.validate()
        if not self.sharing.is_time_slicing() \
                or self.sharing.time_slicing_config is not None:
            raise ValidationError(
                "a MIG device takes only the TimeSlicing strategy, with no "
                "timeSlicingConfig: the driver time-slices its compute "
                "instance, and MPS on a MIG device is not supported")


@dataclass
class PassthroughConfig(_ConfigBase):
    """Whole-GPU VM passthrough marker: no fields. Feature-gated by
    PassthroughSupport."""
    KIND = PASSTHROUGH_CONFIG_KIND

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True):
        _unknown_fields(data, {"apiVersion", "kind"}, strict, self_path(cls))
        return cls()

    def to_dict(self) -> Dict[str, Any]:
        return self.type_meta()

    def normalize(self):
        pass

    def validate(self):
        if not featuregates.enabled(featuregates.PassthroughSupport):
            raise ValidationError(
                "PassthroughConfig requires the PassthroughSupport feature gate")


@dataclass
class ComputeDomainChannelConfig(_ConfigBase):
    """Carried by the workload ResourceClaimTemplate the controller stamps
    per ComputeDomain."""
    KIND = COMPUTE_DOMAIN_CHANNEL_CONFIG_KIND
    domain_id: str = ""
    allocation_mode: str = ALLOCATION_MODE_SINGLE

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True):
        _unknown_fields(data, {"apiVersion", "kind", "domainID", "allocationMode"},
                        strict, self_path(cls))
        return cls(domain_id=data.get("domainID", ""),
                   allocation_mode=data.get("allocationMode", ALLOCATION_MODE_SINGLE))

    def to_dict(self) -> Dict[str, Any]:
        out = self.type_meta()
        out["domainID"] = self.domain_id
        out["allocationMode"] = self.allocation_mode
        return out

    def normalize(self):
        if not self.allocation_mode:
            self.allocation_mode = ALLOCATION_MODE_SINGLE

    def validate(self):
        if not self.domain_id:
            raise ValidationError("domainID must be set")
        if self.allocation_mode not in (ALLOCATION_MODE_SINGLE, ALLOCATION_MODE_ALL):
            raise ValidationError(
                f"allocationMode must be Single or All, got {self.allocation_mode!r}")


@dataclass
class ComputeDomainDaemonConfig(_ConfigBase):
    """Carried by the daemon ResourceClaimTemplate."""
    KIND = COMPUTE_DOMAIN_DAEMON_CONFIG_KIND
    domain_id: str = ""

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True):
        _unknown_fields(data, {"apiVersion", "kind", "domainID"}, strict, self_path(cls))
        return cls(domain_id=data.get("domainID", ""))

    def to_dict(self) -> Dict[str, Any]:
        out = self.type_meta()
        out["domainID"] = self.domain_id
        return out

    def normalize(self):
        pass

    def validate(self):
        if not self.domain_id:
            raise ValidationError("domainID must be set")


# ---------------------------------------------------------------------------
# ComputeDomain CRD
# ---------------------------------------------------------------------------

@dataclass
class ComputeDomainResourceClaimTemplate:
    name: str = ""

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str):
        _unknown_fields(data, {"name"}, strict, path)
        return cls(name=data.get("name", ""))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name}


@dataclass
class ComputeDomainChannelSpec:
    resource_claim_template: ComputeDomainResourceClaimTemplate = field(
        default_factory=ComputeDomainResourceClaimTemplate)
    allocation_mode: str = ALLOCATION_MODE_SINGLE

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "spec.channel"):
        _unknown_fields(data, {"resourceClaimTemplate", "allocationMode"}, strict, path)
        rct = ComputeDomainResourceClaimTemplate.from_dict(
            data.get("resourceClaimTemplate", {}), strict, f"{path}.resourceClaimTemplate")
        return cls(resource_claim_template=rct,
                   allocation_mode=data.get("allocationMode", ALLOCATION_MODE_SINGLE))

    def to_dict(self) -> Dict[str, Any]:
        return {"resourceClaimTemplate": self.resource_claim_template.to_dict(),
                "allocationMode": self.allocation_mode}


@dataclass
class ComputeDomainSpec:
    """Spec is immutable after creation (CEL ``self == oldSelf`` in the
    CRD manifest, tpu_dra_torch.api.crd).

    ``numNodes`` only drives the global Ready status: daemons start
    eagerly and workload pods release as soon as their local daemon is
    ready."""
    num_nodes: int = 0
    channel: Optional[ComputeDomainChannelSpec] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "spec"):
        _unknown_fields(data, {"numNodes", "channel"}, strict, path)
        channel = None
        if data.get("channel") is not None:
            channel = ComputeDomainChannelSpec.from_dict(data["channel"], strict)
        return cls(num_nodes=data.get("numNodes", 0), channel=channel)

    def to_dict(self) -> Dict[str, Any]:
        return {"numNodes": self.num_nodes,
                "channel": self.channel.to_dict() if self.channel else None}


@dataclass
class ComputeDomainNode:
    """One node registered into the domain. ``clique_id`` is the NVLink
    clique of its GPUs; (clique_id, index) is unique, and the index pins
    the node's stable DNS name within its clique. An empty clique_id
    marks a member that reaches its peers over the network only."""
    name: str = ""
    ip_address: str = ""
    clique_id: str = ""
    index: int = 0
    status: str = COMPUTE_DOMAIN_STATUS_NOT_READY

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str):
        _unknown_fields(data, {"name", "ipAddress", "cliqueID", "index", "status"},
                        strict, path)
        return cls(name=data.get("name", ""), ip_address=data.get("ipAddress", ""),
                   clique_id=data.get("cliqueID", ""), index=data.get("index", 0),
                   status=data.get("status", COMPUTE_DOMAIN_STATUS_NOT_READY))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ipAddress": self.ip_address,
                "cliqueID": self.clique_id, "index": self.index, "status": self.status}


@dataclass
class ComputeDomainStatus:
    status: str = COMPUTE_DOMAIN_STATUS_NOT_READY
    nodes: List[ComputeDomainNode] = field(default_factory=list)

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool, path: str = "status"):
        _unknown_fields(data, {"status", "nodes"}, strict, path)
        raw_nodes = data.get("nodes") or []
        _require_type(raw_nodes, list, f"{path}.nodes")
        nodes = [ComputeDomainNode.from_dict(n, strict, f"{path}.nodes[{i}]")
                 for i, n in enumerate(raw_nodes)]
        return cls(status=data.get("status", COMPUTE_DOMAIN_STATUS_NOT_READY), nodes=nodes)

    def to_dict(self) -> Dict[str, Any]:
        return {"status": self.status, "nodes": [n.to_dict() for n in self.nodes]}


@dataclass
class ComputeDomain(_ConfigBase):
    """The ComputeDomain CR: prepares a set of nodes to run one
    multi-node workload over NVLink and the network."""
    KIND = COMPUTE_DOMAIN_KIND
    metadata: Dict[str, Any] = field(default_factory=dict)
    spec: ComputeDomainSpec = field(default_factory=ComputeDomainSpec)
    status: ComputeDomainStatus = field(default_factory=ComputeDomainStatus)

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True):
        _unknown_fields(data, {"apiVersion", "kind", "metadata", "spec", "status"},
                        strict, self_path(cls))
        metadata = data.get("metadata") or {}
        _require_type(metadata, dict, "metadata")
        spec = ComputeDomainSpec.from_dict(data.get("spec") or {}, strict)
        status = ComputeDomainStatus.from_dict(data.get("status") or {}, strict)
        return cls(metadata=dict(metadata), spec=spec, status=status)

    def to_dict(self) -> Dict[str, Any]:
        out = self.type_meta()
        out["metadata"] = self.metadata
        out["spec"] = self.spec.to_dict()
        out["status"] = self.status.to_dict()
        return out

    def normalize(self):
        if self.spec.channel is not None and not self.spec.channel.allocation_mode:
            self.spec.channel.allocation_mode = ALLOCATION_MODE_SINGLE

    def validate(self):
        if self.spec.num_nodes < 0:
            raise ValidationError("spec.numNodes must be >= 0")
        if self.spec.channel is None:
            raise ValidationError("spec.channel must be set")
        if not self.spec.channel.resource_claim_template.name:
            raise ValidationError("spec.channel.resourceClaimTemplate.name must be set")
        if self.spec.channel.allocation_mode not in (
                ALLOCATION_MODE_SINGLE, ALLOCATION_MODE_ALL):
            raise ValidationError(
                "spec.channel.allocationMode must be Single or All")

    @property
    def uid(self) -> str:
        return self.metadata.get("uid", "")

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "")


def self_path(cls) -> str:
    return getattr(cls, "KIND", cls.__name__)
