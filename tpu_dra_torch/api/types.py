"""API group ``resource.gpu.dev/v1beta1``: the opaque config kinds of the
GPU driver (counterpart of tpu_dra/api/types.py).

The TPU reference's kinds map back onto their GPU originals:

- ``TpuConfig``         -> ``GpuConfig``        (a whole GPU)
- ``SubsliceConfig``    -> ``MigDeviceConfig``  (a MIG device of a GPU)
- ``PassthroughConfig`` -> ``PassthroughConfig`` (whole-GPU VFIO marker)
- sharing ``TimeSlicing`` stays; ``Multiprocess`` becomes ``MPS`` with the
  MPS control daemon's knobs (active-thread percentage, pinned device
  memory limits).

The compute-domain kinds and the ComputeDomain CRD come with the
multi-node slice. Every type implements ``normalize()``/``validate()``
and ``from_dict(strict=...)``/``to_dict()``, and is registered with the
scheme in ``tpu_dra_torch.api.scheme``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.quantity import Quantity

GROUP = "resource.gpu.dev"
VERSION = "v1beta1"
API_VERSION = f"{GROUP}/{VERSION}"

# The DRA driver name (the reference's tpu.dev).
GPU_DRIVER_NAME = "gpu.dev"

GPU_CONFIG_KIND = "GpuConfig"
MIG_DEVICE_CONFIG_KIND = "MigDeviceConfig"
PASSTHROUGH_CONFIG_KIND = "PassthroughConfig"

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
    """Per-claim config for a MIG device of a GPU. The MIG profile is chosen
    by the scheduler through device selection; this config carries only
    sharing settings for it."""
    KIND = MIG_DEVICE_CONFIG_KIND


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


def self_path(cls) -> str:
    return getattr(cls, "KIND", cls.__name__)
