"""Minimal Prometheus-compatible metrics registry and HTTP exposition
(counterpart of tpu_dra/infra/metrics.py).

Counters, gauges and fixed-bucket histograms with label support, the
text exposition format, and ``MetricsServer``: /metrics, /healthz (with
the kubelet plugin's self-probe) and the thread-stack dump at
/debug/stacks. Only the instruments the port's modules register are
here: the checkpoint journal's, the tracer's, the quarantine gauge, the
kubelet plugin's prepare and RPC instruments (each in its own module)
and the mesh-build counter below. The metric names are the reference's,
so one dashboard reads both. The reference's control-plane instruments
and its metric catalog come with the slices that use them.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.infra import debug


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


class Histogram(_Metric):
    """Fixed-bucket histogram; exposes _bucket/_sum/_count series."""

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name: str, help_text: str = "", buckets=None):
        super().__init__(name, help_text, "histogram")
        self._buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self._buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._n += 1
            for i, b in enumerate(self._buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def expose(self) -> List[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                     f"# TYPE {self.name} histogram"]
            cum = 0
            for b, c in zip(self._buckets, self._counts):
                cum += c
                lines.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._n}')
            lines.append(f"{self.name}_sum {self._sum}")
            lines.append(f"{self.name}_count {self._n}")
            return lines


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

    def histogram(self, name: str, help_text: str = "", buckets=None) -> Histogram:
        return self.register(Histogram(name, help_text, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        with self._lock:
            out: List[str] = []
            for m in self._metrics:
                out.extend(m.expose())
            return "\n".join(out) + "\n"


DefaultRegistry = Registry()


class MetricsServer:
    """Serves /metrics (text exposition), /debug/stacks (the thread-stack
    dump) and /healthz. With a `health_probe` callable, /healthz runs it
    per request and returns 503 when it reports unhealthy."""

    def __init__(self, addr: str = "127.0.0.1", port: int = 0,
                 registry: Registry = DefaultRegistry,
                 health_probe=None):
        registry_ref = registry
        probe_ref = health_probe

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    body = registry_ref.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                elif self.path == "/debug/stacks":
                    path = debug.dump_stacks()
                    with open(path, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                elif self.path == "/healthz":
                    healthy = True
                    detail = "ok"
                    if probe_ref is not None:
                        try:
                            healthy = bool(probe_ref())
                            detail = "ok" if healthy else "probe failed"
                        except Exception as e:  # noqa: BLE001
                            healthy, detail = False, str(e)
                    body = detail.encode()
                    self.send_response(200 if healthy else 503)
                else:
                    body = b"not found"
                    self.send_response(404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((addr, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# Allocation -> mesh handoff (topology/meshexport): plan builds by outcome.
MESH_BUILDS = DefaultRegistry.counter(
    "tpu_dra_mesh_builds_total",
    "allocation -> MeshPlan constructions, labeled by outcome: ok "
    "(contiguous block, all-neighbor ring), fragmented (plan still "
    "builds but the modeled hop cost is above the block's floor), "
    "refused (rank/topology mismatch, duplicate or out-of-bounds "
    "coordinates — the loud-refusal contract)")
