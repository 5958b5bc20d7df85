"""Minimal Prometheus-compatible metrics registry (counterpart of
tpu_dra/infra/metrics.py).

Counters and gauges with label support and the text exposition format.
Only the instruments the port's modules register are here: the
checkpoint journal's, the tracer's, the quarantine gauge (each in its
own module) and the mesh-build counter below. The metric names are the
reference's, so one dashboard reads both. The reference's histograms,
HTTP exposition server and control-plane instruments come with the
slices that use them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


def _escape_label_value(value: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash,
    double-quote and newline must be escaped or a hostile/accidental
    value ('say "hi"\\n') tears the scrape line."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (quotes are legal)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


class _Metric:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Optional[Dict[str, str]]):
        return tuple(sorted((labels or {}).items()))

    def value(self, labels: Optional[Dict[str, str]] = None,
              default: float = 0.0) -> float:
        """Current scalar for one label set — the programmatic read seam
        tests and the bench use instead of scraping the text exposition.

        Empty-state contract: a label set never touched returns
        `default` (0.0) — identical to a counter that exists but never
        incremented, which is what PromQL's absent-as-zero arithmetic
        assumes. Callers that must distinguish "never touched" from
        "zero" pass a sentinel default or check ``labelsets()``."""
        with self._lock:
            return self._values.get(self._key(labels), default)

    def labelsets(self) -> List[Dict[str, str]]:
        """Label sets that have actually been touched — the explicit
        never-touched-vs-zero discriminator ``value()`` cannot be."""
        with self._lock:
            return [dict(k) for k in sorted(self._values)]

    def expose(self) -> List[str]:
        # Label sets render stably sorted (the _key tuples are
        # themselves label-name-sorted), so consecutive scrapes of the
        # same state are byte-identical and scrape diffs stay readable.
        with self._lock:
            lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                     f"# TYPE {self.name} {self.kind}"]
            for key, val in sorted(self._values.items()):
                if key:
                    lbl = ",".join(
                        f'{k}="{_escape_label_value(v)}"' for k, v in key)
                    lines.append(f"{self.name}{{{lbl}}} {val}")
                else:
                    lines.append(f"{self.name} {val}")
            return lines


class Counter(_Metric):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "counter")

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount


class Gauge(_Metric):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "gauge")

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(labels)] = value


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self.register(Counter(name, help_text))  # type: ignore[return-value]

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self.register(Gauge(name, help_text))  # type: ignore[return-value]

    def expose(self) -> str:
        with self._lock:
            out: List[str] = []
            for m in self._metrics:
                out.extend(m.expose())
            return "\n".join(out) + "\n"


DefaultRegistry = Registry()

# Allocation -> mesh handoff (topology/meshexport): plan builds by outcome.
MESH_BUILDS = DefaultRegistry.counter(
    "tpu_dra_mesh_builds_total",
    "allocation -> MeshPlan constructions, labeled by outcome: ok "
    "(contiguous block, all-neighbor ring), fragmented (plan still "
    "builds but the modeled hop cost is above the block's floor), "
    "refused (rank/topology mismatch, duplicate or out-of-bounds "
    "coordinates — the loud-refusal contract)")
