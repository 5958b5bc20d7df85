"""Minimal Prometheus-compatible metrics registry and HTTP exposition
(counterpart of tpu_dra/infra/metrics.py).

Counters, gauges and fixed-bucket histograms with label support, the
text exposition format, and ``MetricsServer``: /metrics, /healthz (with
the kubelet plugin's self-probe) and the thread-stack dump at
/debug/stacks. Only the instruments the port's modules register are
here: the checkpoint journal's, the tracer's, the quarantine gauge, the
kubelet plugin's prepare and RPC instruments (each in its own module),
the mesh-build counter, the control plane's (the sim scheduler's,
its CEL cache's and the leader election's), the work queues' and the
model checker's below. The metric names are the reference's, so one
dashboard reads both; ``METRICS_CATALOG`` lists every one of them.
"""

from __future__ import annotations

import threading
import time
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

    @property
    def count(self) -> int:
        """Observations so far (the _count series, programmatically)."""
        with self._lock:
            return self._n

    @property
    def total(self) -> float:
        """Sum of observed values (the _sum series, programmatically)."""
        with self._lock:
            return self._sum

    def bucket_counts(self) -> Tuple[int, ...]:
        """Raw per-bucket counts snapshot (finite buckets + overflow) —
        the baseline handle for ``percentile_since``."""
        with self._lock:
            return tuple(self._counts)

    def percentile_since(self, baseline: Tuple[int, ...], q: float,
                         default: float = 0.0) -> float:
        """Approximate percentile, from bucket upper bounds, of the
        observations made after `baseline` (a ``bucket_counts()``
        snapshot): the phase-scoped read of a histogram that already holds
        a process lifetime. `default` when there is none, +Inf above the
        largest finite bucket."""
        with self._lock:
            deltas = [c - b for c, b in zip(self._counts, baseline)]
            n = sum(deltas)
            if n == 0:
                return default
            target = q * n
            cum = 0
            for b, c in zip(self._buckets, deltas):
                cum += c
                if cum >= target:
                    return b
            return float("inf")

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

# ---------------------------------------------------------------------------
# Metric catalog (dralint R5)
# ---------------------------------------------------------------------------
# Every metric the port registers, by the module whose DefaultRegistry.
# counter/gauge/histogram call registers it. The port's dralint
# (tpu_dra_torch.analysis) enforces both directions: a registration whose
# name is missing here fails lint, and a cataloged name nobody registers is
# an orphan. Names must match ``tpu_dra_[a-z0-9_]+``.
METRICS_CATALOG: Dict[str, str] = {
    "tpu_dra_lint_cache_hits_total": "analysis/core.py",
    "tpu_dra_lint_findings_total": "analysis/core.py",
    "tpu_dra_cd_degraded_total": "cdcontroller/controller.py",
    "tpu_dra_cd_reconciles_total": "cdcontroller/controller.py",
    "tpu_dra_cd_teardowns_total": "cdcontroller/controller.py",
    "tpu_dra_cd_claim_prepare_seconds": "cdplugin/driver.py",
    "tpu_dra_journal_appends_total": "gpuplugin/checkpoint.py",
    "tpu_dra_journal_compactions_total": "gpuplugin/checkpoint.py",
    "tpu_dra_journal_group_syncs_total": "gpuplugin/checkpoint.py",
    "tpu_dra_journal_lag_records": "gpuplugin/checkpoint.py",
    "tpu_dra_journal_rotations_total": "gpuplugin/checkpoint.py",
    "tpu_dra_journal_window_holds_total": "gpuplugin/checkpoint.py",
    "tpu_dra_quarantined_chips": "gpuplugin/device_state.py",
    "tpu_dra_claim_prepare_seconds": "gpuplugin/driver.py",
    "tpu_dra_prepare_batch_size": "gpuplugin/driver.py",
    "tpu_dra_prepare_wire_decode_seconds": "gpuplugin/driver.py",
    "tpu_dra_prepare_wire_encode_seconds": "gpuplugin/driver.py",
    "tpu_dra_prepare_wire_queue_seconds": "gpuplugin/driver.py",
    "tpu_dra_health_monitor_wedged": "gpuplugin/health.py",
    "tpu_dra_cel_cache_hits": "infra/metrics.py",
    "tpu_dra_cel_cache_misses": "infra/metrics.py",
    "tpu_dra_cel_compiles": "infra/metrics.py",
    "tpu_dra_drmc_crashpoints_total": "infra/metrics.py",
    "tpu_dra_drmc_schedules_total": "infra/metrics.py",
    "tpu_dra_mesh_builds_total": "infra/metrics.py",
    "tpu_dra_psum_bandwidth_gbps": "infra/metrics.py",
    "tpu_dra_sched_claims_gced": "infra/metrics.py",
    "tpu_dra_sched_evictions_total": "infra/metrics.py",
    "tpu_dra_sched_full_relists": "infra/metrics.py",
    "tpu_dra_sched_leader": "infra/metrics.py",
    "tpu_dra_sched_lease_transitions_total": "infra/metrics.py",
    "tpu_dra_sched_pods_bound": "infra/metrics.py",
    "tpu_dra_sched_shard_resyncs_total": "infra/metrics.py",
    "tpu_dra_sched_snapshot_conflicts_total": "infra/metrics.py",
    "tpu_dra_sched_watch_events": "infra/metrics.py",
    "tpu_dra_sched_workers": "infra/metrics.py",
    "tpu_dra_topo_allocations": "infra/metrics.py",
    "tpu_dra_topo_free_cuboid_chips": "infra/metrics.py",
    "tpu_dra_topo_score_seconds": "infra/metrics.py",
    "tpu_dra_workqueue_busy_workers": "infra/metrics.py",
    "tpu_dra_workqueue_depth": "infra/metrics.py",
    "tpu_dra_flightrecorder_dumps_total": "infra/trace.py",
    "tpu_dra_flightrecorder_ring_occupancy": "infra/trace.py",
    "tpu_dra_trace_spans_completed_total": "infra/trace.py",
    "tpu_dra_trace_spans_dropped_total": "infra/trace.py",
    "tpu_dra_trace_spans_started_total": "infra/trace.py",
    "tpu_dra_informer_relists_total": "k8s/informer.py",
    "tpu_dra_informer_shard_overflows_total": "k8s/informer.py",
    "tpu_dra_rpc_loop_lag_seconds": "kubeletplugin/aio_server.py",
    "tpu_dra_rpc_sustained_inflight": "kubeletplugin/aio_server.py",
    "tpu_dra_prepare_inflight_rpcs": "kubeletplugin/pipeline.py",
    "tpu_dra_rpc_drain_seconds": "kubeletplugin/pipeline.py",
    "tpu_dra_rpc_reconnects_total": "kubeletplugin/server.py",
}


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

# Workload data plane (workloads/meshbuild): measured all-reduce bandwidth.
PSUM_BW = DefaultRegistry.histogram(
    "tpu_dra_psum_bandwidth_gbps",
    "measured all-reduce algorithm bandwidth (GB/s) per collective run "
    "on a driver-allocated mesh (the bench's psum phase and any "
    "launch_workload('allreduce') caller)",
    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 200.0,
             400.0, 800.0))


class Timer:
    """Context manager observing elapsed seconds into a Histogram."""

    def __init__(self, hist: "Histogram"):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.monotonic() - self._t0)


# ---------------------------------------------------------------------------
# Control plane (the sim scheduler and its CEL compile cache): defined
# here because two layers share them (simcluster.cel compiles,
# simcluster.scheduler evaluates and resyncs).
# ---------------------------------------------------------------------------

CEL_CACHE_HITS = DefaultRegistry.counter(
    "tpu_dra_cel_cache_hits",
    "CEL compile-cache lookups that found a cached program")
CEL_CACHE_MISSES = DefaultRegistry.counter(
    "tpu_dra_cel_cache_misses",
    "CEL compile-cache lookups that found nothing (a compile follows)")
CEL_COMPILES = DefaultRegistry.counter(
    "tpu_dra_cel_compiles",
    "CEL expressions actually tokenized+parsed; steady state this equals "
    "the number of DISTINCT selector sources seen")
SCHED_FULL_RELISTS = DefaultRegistry.counter(
    "tpu_dra_sched_full_relists",
    "scheduler-level full rescans: sync-mode reconcile_once calls plus "
    "dirty-shard resyncs; steady-state event-driven target is 0")
SCHED_WATCH_EVENTS = DefaultRegistry.counter(
    "tpu_dra_sched_watch_events",
    "watch events applied by the scheduler, labeled by resource")
SCHED_PODS_BOUND = DefaultRegistry.counter(
    "tpu_dra_sched_pods_bound",
    "pods bound to a node by the sim scheduler")
SCHED_CLAIMS_GCED = DefaultRegistry.counter(
    "tpu_dra_sched_claims_gced",
    "template-owned ResourceClaims garbage-collected after pod death, "
    "labeled by path (event|sweep)")
SCHED_WORKERS = DefaultRegistry.gauge(
    "tpu_dra_sched_workers",
    "reconcile worker threads the scheduler's WorkQueue pool runs")
SCHED_SNAPSHOT_CONFLICTS = DefaultRegistry.counter(
    "tpu_dra_sched_snapshot_conflicts_total",
    "optimistic snapshot commits refused because the shard moved "
    "underneath the scan (or the sched.snapshot_commit fault fired); "
    "each conflict re-scans against a fresh snapshot, bounded before "
    "backoff-requeue")
SCHED_SHARD_RESYNCS = DefaultRegistry.counter(
    "tpu_dra_sched_shard_resyncs_total",
    "allocation-index shards rebuilt by the guarded resync fallback")
SCHED_EVICTIONS = DefaultRegistry.counter(
    "tpu_dra_sched_evictions_total",
    "claims evicted because an allocated device disappeared from the "
    "published inventory (GPU yanked by the health pipeline, node lost), "
    "labeled by reason (device_lost|node_lost)")
TOPO_ALLOCS = DefaultRegistry.counter(
    "tpu_dra_topo_allocations",
    "multi-GPU device picks, labeled by outcome: contiguous (topology-"
    "scored block), fallback (node publishes no usable topology -> "
    "first-fit), unplaceable (no contiguous block fits the free set; "
    "the claim waits)")
TOPO_SCORE_SECONDS = DefaultRegistry.histogram(
    "tpu_dra_topo_score_seconds",
    "wall seconds spent on the topology path per multi-GPU pick: "
    "placement scan+score plus the free-block fragmentation observe",
    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
             0.01, 0.025, 0.05, 0.1, 0.5))
TOPO_FREE_CUBOID = DefaultRegistry.histogram(
    "tpu_dra_topo_free_cuboid_chips",
    "largest free block (GPUs) remaining on the node after each "
    "topology-scored placement — the fragmentation observable",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))

# -- HA control plane (active-standby leases + takeover): read by the
# leader elector, the failover bench and the chip smoke's ops phase. ---------

SCHED_LEADER = DefaultRegistry.gauge(
    "tpu_dra_sched_leader",
    "1 while this elector holds the scheduler lease, 0 while standby or "
    "after stepping down/deposal, labeled by identity — the failover "
    "dashboards' who-is-acting signal")
SCHED_LEASE_TRANSITIONS = DefaultRegistry.counter(
    "tpu_dra_sched_lease_transitions_total",
    "lease acquisitions (first grab + every takeover) observed by the "
    "electors of this process; each one bumps the fencing generation "
    "that deposed-leader claim-status writes are refused against")

# -- work queues (infra.workqueue): a named queue's depth and busy pool
# workers. -------------------------------------------------------------------

WORKQUEUE_DEPTH = DefaultRegistry.gauge(
    "tpu_dra_workqueue_depth",
    "items queued (delay heap + per-key deferred) in a named WorkQueue, "
    "labeled by queue")
WORKQUEUE_BUSY = DefaultRegistry.gauge(
    "tpu_dra_workqueue_busy_workers",
    "pool workers currently processing an item, labeled by queue")

# -- drmc model checker (tpu_dra_torch.analysis.drmc): exploration volume,
# labeled by scenario. --------------------------------------------------------

DRMC_SCHEDULES = DefaultRegistry.counter(
    "tpu_dra_drmc_schedules_total",
    "controlled-scheduler interleavings executed by the drmc explorer, "
    "labeled by scenario")
DRMC_CRASHPOINTS = DefaultRegistry.counter(
    "tpu_dra_drmc_crashpoints_total",
    "crash-point variants (post-op, torn, all-persisted) enumerated and "
    "recovered by the drmc crash engine, labeled by scenario")
