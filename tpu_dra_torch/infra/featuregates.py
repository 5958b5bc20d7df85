"""Versioned feature gates.

Reference: pkg/featuregates/featuregates.go:31-156 — k8s component-base style
versioned feature gates, threaded into templates as a ``FEATURE_GATES`` env
var. We keep the same lifecycle model (Alpha/Beta/GA + lockToDefault) and the
same spelling of the gate-string syntax (``Name=true,Other=false``) so Helm
values and env plumbing round-trip identically.

Only the gates the port reads are registered; a gate joins with the
module that consults it:
- TimeSlicingSettings  (GPU time-slice config)
- MultiprocessSupport  (MPS sharing: the MPS strategy validates, and the
  plugin runs a control-daemon Deployment per MPS claim)
- PassthroughSupport   (VFIO passthrough: PassthroughConfig validates, and
  the plugin rebinds a passthrough claim's IOMMU group to vfio-pci)
- NVMLDeviceHealthCheck (the kubelet plugin's NVML health monitor; on by
  default, beta, as the reference's TPUDeviceHealthCheck)
- DomainDaemonsWithDNSNames (the compute-domain daemon's stable per-clique
  DNS names; on by default, beta, as the reference's
  SliceDaemonsWithDNSNames)
- TopologyAwareScheduling (the compute-domain controller's NVLink
  placement summary in status.topology)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass
class FeatureSpec:
    """One gate's lifecycle at a particular driver version."""
    default: bool
    lock_to_default: bool = False
    pre_release: str = ALPHA


@dataclass
class VersionedSpecs:
    """Version-ordered specs; the active spec is the newest one whose
    introduced-version is <= the compiled driver version (we only model the
    newest, matching how the reference resolves gates at startup)."""
    specs: Tuple[Tuple[str, FeatureSpec], ...] = field(default_factory=tuple)

    def current(self) -> FeatureSpec:
        return self.specs[-1][1]


# Gate names
TimeSlicingSettings = "TimeSlicingSettings"
MultiprocessSupport = "MultiprocessSupport"
PassthroughSupport = "PassthroughSupport"
NVMLDeviceHealthCheck = "NVMLDeviceHealthCheck"
DomainDaemonsWithDNSNames = "DomainDaemonsWithDNSNames"
TopologyAwareScheduling = "TopologyAwareScheduling"

_DEFAULT_FEATURES: Dict[str, VersionedSpecs] = {
    TimeSlicingSettings: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=False, pre_release=ALPHA)),
    )),
    MultiprocessSupport: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=False, pre_release=ALPHA)),
    )),
    PassthroughSupport: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=False, pre_release=ALPHA)),
    )),
    NVMLDeviceHealthCheck: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=True, pre_release=BETA)),
    )),
    DomainDaemonsWithDNSNames: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=True, pre_release=BETA)),
    )),
    TopologyAwareScheduling: VersionedSpecs((
        ("0.1.0", FeatureSpec(default=False, pre_release=ALPHA)),
    )),
}


class FeatureGate:
    """Mutable-until-frozen feature gate registry.

    Mirrors the semantics the reference gets from k8s component-base:
    unknown gates error, locked gates refuse overrides, and the parsed
    state is process-global (gates are consulted from deep inside config
    Normalize/Validate paths).
    """

    def __init__(self, features: Dict[str, VersionedSpecs] | None = None):
        self._lock = threading.Lock()
        self._features = dict(features if features is not None else _DEFAULT_FEATURES)
        self._overrides: Dict[str, bool] = {}

    def known(self) -> Iterable[str]:
        # Under the lock: sorted() iterates the dict, and a concurrent
        # add() mid-iteration raises (draracer R10 caught this).
        with self._lock:
            return sorted(self._features)

    def add(self, name: str, spec: VersionedSpecs) -> None:
        with self._lock:
            if name in self._features:
                raise ValueError(f"feature gate {name} already registered")
            self._features[name] = spec

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name not in self._features:
                raise KeyError(f"unknown feature gate: {name}")
            if name in self._overrides:
                return self._overrides[name]
            return self._features[name].current().default

    def set_from_map(self, values: Dict[str, bool]) -> None:
        """Validate the whole map, then commit atomically (half-applied gate
        sets must never be observable, matching component-base semantics).
        All rejection paths raise ValueError."""
        with self._lock:
            staged: Dict[str, bool] = {}
            for name, val in values.items():
                if name not in self._features:
                    raise ValueError(f"unknown feature gate: {name}")
                spec = self._features[name].current()
                if spec.lock_to_default and val != spec.default:
                    raise ValueError(
                        f"cannot set feature gate {name} to {val}: locked to {spec.default}")
                staged[name] = val
            self._overrides.update(staged)

    def set_from_string(self, s: str) -> None:
        """Parse ``Name=true,Other=false`` (the FEATURE_GATES env format)."""
        values: Dict[str, bool] = {}
        for part in filter(None, (p.strip() for p in s.split(","))):
            if "=" not in part:
                raise ValueError(f"missing '=' in feature gate assignment {part!r}")
            name, _, raw = part.partition("=")
            raw = raw.strip().lower()
            if raw not in ("true", "false"):
                raise ValueError(f"invalid boolean {raw!r} for feature gate {name!r}")
            values[name.strip()] = raw == "true"
        self.set_from_map(values)

    def snapshot(self) -> Dict[str, bool]:
        with self._lock:
            return {n: self._overrides.get(n, vs.current().default)
                    for n, vs in self._features.items()}

    def as_string(self) -> str:
        return ",".join(f"{n}={'true' if v else 'false'}"
                        for n, v in sorted(self.snapshot().items()))

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()

    def overrides_snapshot(self) -> Dict[str, bool]:
        """The explicit overrides only (unlike snapshot(), which folds in
        defaults) — the value restore_overrides() round-trips, for code
        that must temporarily flip gates without wiping what the process
        set before it."""
        with self._lock:
            return dict(self._overrides)

    def restore_overrides(self, overrides: Dict[str, bool]) -> None:
        with self._lock:
            self._overrides = dict(overrides)


# Process-global gate registry, like the reference's package-level Features.
Features = FeatureGate()


def enabled(name: str) -> bool:
    return Features.enabled(name)
