"""GPU kubelet plugin driver: DRA callbacks + publishing + health wiring
(counterpart of tpu_dra/tpuplugin/driver.py).

Implements the kubeletplugin callbacks, holds a per-node flock so two
driver pods (rolling upgrade) never interleave prepare/unprepare,
publishes the node's ResourceSlice, registers with kubelet only after
the first publish lands, and republishes on health events.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.gpuplugin.health import DeviceHealthMonitor, RECOVERED_KIND
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS, FaultInjected
from tpu_dra_torch.infra.flock import Flock, SharedFlock
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.infra.trace import TRACEPARENT_ANNOTATION, TRACER
from tpu_dra_torch.infra.workqueue import (
    WorkQueue, default_prep_unprep_rate_limiter,
)
from tpu_dra_torch.k8s import ApiClient, RESOURCECLAIMS
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.kubeletplugin.pipeline import RpcPipeline
from tpu_dra_torch.kubeletplugin.server import (
    Claim, DRAPluginServer, DriverCallbacks, PrepareResult, publish_resources,
)
from tpu_dra_torch.native.gpuinfo import HealthEvent

log = logging.getLogger("tpu_dra_torch.gpuplugin")

claim_prepare_seconds = DefaultRegistry.histogram(
    "tpu_dra_claim_prepare_seconds",
    "NodePrepareResources batch-amortized per-claim latency (batch wall / "
    "claims, observed once per claim; claims in a batch complete together, "
    "so individual tails live in the batch wall, not here)")

prepare_batch_size = DefaultRegistry.histogram(
    "tpu_dra_prepare_batch_size",
    "Claims per NodePrepareResources RPC (kubelet batches a pod's claims; "
    "the batch is the group-commit unit)",
    buckets=(1, 2, 4, 8, 16, 32, 64))

# Wire-breakdown components: the server-side share of
# prepare_breakdown_rpc_wire_ms, split so a wire regression names its
# stage — request decode (claim-list build), pipeline queueing
# (admission window + per-claim-set ordering), response encode.
_WIRE_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                 0.005, 0.01, 0.05)
wire_decode_seconds = DefaultRegistry.histogram(
    "tpu_dra_prepare_wire_decode_seconds",
    "server-side request-decode stage per prepare RPC",
    buckets=_WIRE_BUCKETS)
wire_queue_seconds = DefaultRegistry.histogram(
    "tpu_dra_prepare_wire_queue_seconds",
    "pipeline queue stage per prepare RPC: in-flight-window admission "
    "plus per-claim-set ordering waits",
    buckets=_WIRE_BUCKETS)
wire_encode_seconds = DefaultRegistry.histogram(
    "tpu_dra_prepare_wire_encode_seconds",
    "server-side response-encode stage per prepare RPC",
    buckets=_WIRE_BUCKETS)


class GpuDriver(DriverCallbacks):
    """The kubelet plugin of one node: DeviceState behind the DRA sockets.

    kubelet_grpc=False serves the framed socket alone (no gRPC, so no
    kubelet registration): for a host without the grpc package."""

    def __init__(self, *, state: DeviceState, client: ApiClient,
                 driver_name: str, node_name: str,
                 plugin_dir: str, registry_dir: Optional[str] = None,
                 flock_path: Optional[str] = None,
                 additional_codes_to_ignore=None,
                 kubelet_grpc: bool = True):
        self._state = state
        self._client = client
        self._driver_name = driver_name
        self._node_name = node_name
        # Shared ownership over the node-global flock: the flock fences
        # OTHER processes (rolling upgrade); concurrent RPC threads of
        # this process share it so the pipeline can overlap them.
        self._pu_lock = SharedFlock(Flock(flock_path
                                          or f"{plugin_dir}/pu.lock"))
        # Pipelined admission: bounded in-flight window + per-claim-set
        # keyed ordering (two RPCs touching the same claim never
        # reorder; disjoint RPCs overlap — decode/fetch of RPC N+1 runs
        # while RPC N commits).
        self._pipeline = RpcPipeline()
        # Server-side wire attribution of the LAST prepare RPC
        # ({decode,queue,encode,handler} ms) — the bench's wire-split
        # source, paired with last_prepare_ms.
        self.last_wire_breakdown: Dict[str, float] = {}
        # Per-HANDLER-THREAD queue share: prepare_claims and the
        # server's record_wire callback run on the same gRPC handler
        # thread, and concurrent RPCs are real under the pipeline — a
        # shared field would pair RPC A's decode with RPC B's queue.
        self._wire_tls = threading.local()
        # Claim-fetch fan-out pool: a batch's ResourceClaims are fetched
        # concurrently so the API-server round-trip is paid once per RPC
        # wall-clock, not once per claim. Sized past any realistic
        # per-pod claim count; larger batches just wave through in turns.
        self._fetch_workers = 8
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=self._fetch_workers,
            thread_name_prefix="gpu-dra-claim-fetch")
        # Wall ms of the last prepare_claims batch (flock + claim fetch
        # + DeviceState.prepare_batch): with the client-observed latency
        # this attributes the gRPC wire share of claim-to-ready (bench).
        self.last_prepare_ms: float = 0.0
        self._pool_generation = 1
        self._gen_lock = threading.Lock()
        self.server = DRAPluginServer(
            driver_name=driver_name, node_name=node_name, callbacks=self,
            plugin_dir=plugin_dir, registry_dir=registry_dir,
            kubelet_grpc=kubelet_grpc)
        # Retry queue for ResourceSlice (re)publishing: a failed republish
        # after a health event must not strand a dead GPU in the inventory.
        self._publish_queue = WorkQueue(default_prep_unprep_rate_limiter())
        # Set once the initial ResourceSlice publish lands (start()).
        self.first_published = threading.Event()
        self._health: Optional[DeviceHealthMonitor] = None
        if featuregates.enabled(featuregates.NVMLDeviceHealthCheck):
            self._health = DeviceHealthMonitor(
                state.backend, self._on_unhealthy_event,
                additional_codes_to_ignore=additional_codes_to_ignore)

    # -- lifecycle ----------------------------------------------------------

    def start(self, publish_wait: float = 5.0) -> None:
        """Bring up the DRA sockets, then run the initial ResourceSlice
        publish through the retry queue and gate kubelet REGISTRATION on
        its first success: an API server blip at plugin start backs off
        instead of crashing the pod,
        and kubelet is not told about a driver whose inventory the
        scheduler cannot see yet.

        publish_wait: best-effort block for the first publish so callers
        observe the steady state; on timeout the queue keeps retrying in
        the background (0 to not wait).
        """
        self.server.start(register=False)
        self._publish_queue.run_in_thread()
        if self._health:
            self._health.start()
        self._publish_queue.enqueue(
            None, lambda _obj: self._publish_and_register(), key="publish")
        if publish_wait:
            self.first_published.wait(publish_wait)

    def shutdown(self, drain: bool = True) -> float:
        """Tear down in drain order: stop admitting RPCs and wait out the in-flight pipeline
        (clients see a draining refusal and retry against the next
        incarnation), stop auxiliaries, stop the transports, then run
        the journal barrier so the next incarnation recovers a
        complete tail. Returns the drain window seconds (0.0 when
        drain=False — the crash-shaped teardown tests use)."""
        drain_s = self._pipeline.drain() if drain else 0.0
        if self._health:
            self._health.stop()
        self._publish_queue.shutdown()
        self.server.stop()
        self._fetch_pool.shutdown(wait=True)
        self._state.flush_journal()
        self._state.close()
        return drain_s

    # -- DRA callbacks ------------------------------------------------------

    def prepare_claims(self, claims: List[Claim]) -> Dict[str, PrepareResult]:
        """NodePrepareResources, pipelined: the RPC is the unit of work, and concurrent RPCs overlap. The
        stages per RPC: admission (bounded in-flight window) ->
        concurrent ResourceClaim fetch fan-out (overlaps freely — reads
        the API server, not driver state) -> per-claim-set ordering
        (two RPCs touching the same claim never reorder) -> shared
        flock -> DeviceState group commit, whose journal fdatasync
        coalesces across whichever RPCs reach it together. Per-claim
        errors (404, UID mismatch, prepare failure) isolate to that
        claim's result."""
        t0 = time.monotonic()
        prepare_batch_size.observe(len(claims))
        results: Dict[str, PrepareResult] = {}
        try:
            ticket = self._pipeline.admit(c.uid for c in claims)
        except (TimeoutError, FaultInjected) as e:
            # Window never freed (wedged in-flight RPCs) or an injected
            # admission refusal (prepare.rpc_admit): fail fast so
            # kubelet retries instead of piling blocked handlers.
            return {c.uid: PrepareResult(error=str(e)) for c in claims}
        # uid -> the claim's rpc-level span: continues the trace the
        # scheduler stamped into the claim annotation and
        # re-stamps its OWN traceparent before the state machine sees
        # the object, so every prepare.* span nests under rpc.prepare.
        rpc_spans: Dict[str, object] = {}
        try:
            objs = []
            for claim, (obj, err) in self._fetch_claims(claims):
                if err is not None:
                    results[claim.uid] = PrepareResult(error=err)
                    continue
                span = TRACER.begin(
                    "rpc.prepare", root=True,
                    traceparent=(obj["metadata"].get("annotations")
                                 or {}).get(TRACEPARENT_ANNOTATION),
                    attributes={"claim_uid": claim.uid})
                tp = span.traceparent()
                if tp:
                    obj["metadata"].setdefault(
                        "annotations", {})[TRACEPARENT_ANNOTATION] = tp
                rpc_spans[claim.uid] = span
                objs.append(obj)
            try:
                self._pipeline.order(ticket)
                self._pu_lock.acquire(timeout=10.0)
            except TimeoutError as e:
                for span in rpc_spans.values():
                    span.abandon(str(e))
                rpc_spans.clear()
                return {c.uid: PrepareResult(error=str(e))
                        for c in claims}
            try:
                if objs:
                    results.update(self._state.prepare_batch(objs))
            finally:
                self._pu_lock.release()
            elapsed = time.monotonic() - t0
            # Batch members complete together, so the honest per-claim
            # number is the amortized share (see the metric help text).
            per_claim = elapsed / max(len(claims), 1)
            for _ in claims:
                claim_prepare_seconds.observe(per_claim)
            self.last_prepare_ms = elapsed * 1e3
            self._wire_tls.queue_s = ticket.queue_s
            wire_queue_seconds.observe(ticket.queue_s)
            return results
        finally:
            for uid, span in rpc_spans.items():
                res = results.get(uid)
                if res is None:
                    span.abandon("no result recorded (handler error)")
                elif res.error:
                    span.abandon(res.error)
                else:
                    span.end()
            self._pipeline.done(ticket)

    def unprepare_claims(self, claims: List[Claim]) -> Dict[str, str]:
        """Same pipeline as prepare (shared claim-uid ordering — an
        unprepare never overtakes the prepare it follows), one
        group-committed unprepare per RPC."""
        try:
            ticket = self._pipeline.admit(c.uid for c in claims)
        except (TimeoutError, FaultInjected) as e:
            return {c.uid: str(e) for c in claims}
        try:
            try:
                self._pipeline.order(ticket)
                self._pu_lock.acquire(timeout=10.0)
            except TimeoutError as e:
                return {c.uid: str(e) for c in claims}
            try:
                errors = self._state.unprepare_batch(
                    [c.uid for c in claims])
                return {c.uid: errors.get(c.uid) or "" for c in claims}
            finally:
                self._pu_lock.release()
        finally:
            self._pipeline.done(ticket)

    def record_wire(self, stage_s: Dict[str, float]) -> None:
        """Per-RPC wire attribution from the handler (server.py):
        decode/encode/handler seconds, merged with the pipeline queue
        share measured here. The stage stopwatches are synthesized into
        ``rpc.<stage>`` spans and the bench's `last_wire_breakdown`
        keys are DERIVED from those spans (the span layer is the single
        source of truth for attribution)."""
        queue_s = getattr(self._wire_tls, "queue_s", 0.0)
        self._wire_tls.queue_s = 0.0  # consumed: don't smear onto a
        # later RPC on this thread that timed out before measuring.
        spans = {
            stage: TRACER.record_span(f"rpc.{stage}", seconds)
            for stage, seconds in (
                ("decode", stage_s.get("decode", 0.0)),
                ("queue", queue_s),
                ("encode", stage_s.get("encode", 0.0)),
                ("handler", stage_s.get("handler", 0.0)))}
        wire_decode_seconds.observe(spans["decode"].duration_s)
        wire_encode_seconds.observe(spans["encode"].duration_s)
        self.last_wire_breakdown = {
            stage: span.duration_ms for stage, span in spans.items()}

    def _fetch_claims(self, claims: List[Claim]
                      ) -> List[Tuple[Claim, Tuple[Optional[Dict],
                                                   Optional[str]]]]:
        """Concurrent ResourceClaim fan-out: [(claim, (obj|None,
        err|None))], duplicates collapsed to their first occurrence.
        Single-claim batches fetch inline — pool dispatch buys nothing.
        Larger batches fan out as ONE CHUNK PER WORKER, not one task
        per claim: each task is a sequential loop over its chunk, so a
        64-claim batch costs 8 pool wakeups instead of 64 (sub-ms
        per-claim tasks thrash the executor instead of overlapping)
        while the API round-trips still run 8 wide."""
        unique: List[Claim] = []
        seen = set()
        for claim in claims:
            if claim.uid not in seen:
                seen.add(claim.uid)
                unique.append(claim)
        if len(unique) == 1:
            return [(unique[0], self._fetch_one(unique[0]))]
        n_chunks = min(self._fetch_workers, len(unique))
        chunks = [unique[i::n_chunks] for i in range(n_chunks)]

        def fetch_chunk(chunk):
            return [self._fetch_one(c) for c in chunk]

        futures = [self._fetch_pool.submit(fetch_chunk, ch)
                   for ch in chunks]
        by_uid = {}
        for ch, f in zip(chunks, futures):
            for claim, res in zip(ch, f.result()):
                by_uid[claim.uid] = res
        return [(c, by_uid[c.uid]) for c in unique]

    def _fetch_one(self, claim: Claim
                   ) -> Tuple[Optional[Dict], Optional[str]]:
        """(ResourceClaim, None) or (None, error). Never raises: one
        failed fetch must not take down its batch siblings."""
        try:
            # Injection site: a single claim's fetch fails while the
            # rest of the batch proceeds (error-isolation chaos).
            FAULTS.check("prepare.batch_fetch", claim_uid=claim.uid)
            obj = self._client.get(RESOURCECLAIMS, claim.name,
                                   claim.namespace)
        except NotFoundError:
            return None, (f"resourceclaim {claim.namespace}/{claim.name} "
                          "not found")
        except Exception as e:  # noqa: BLE001 — isolate to this claim
            return None, f"fetch resourceclaim: {e}"
        if obj["metadata"].get("uid") != claim.uid:
            return None, f"claim UID mismatch for {claim.namespace}/{claim.name}"
        return obj, None

    # -- publishing ---------------------------------------------------------

    def publish_resources(self) -> None:
        with self._gen_lock:
            devices = self._state.healthy_devices()
            publish_resources(self._client, self._driver_name, self._node_name,
                              devices, pool_generation=self._pool_generation)
            self._pool_generation += 1

    def _publish_and_register(self) -> None:
        """Single callback behind the "publish" queue key: every enqueue —
        startup AND health republish — goes through here, because the
        queue's latest-wins semantics would otherwise let a health event
        supersede a still-retrying startup publish and silently drop the
        registration gate."""
        self.publish_resources()
        if not self.first_published.is_set():
            self.server.start_registration()
            self.first_published.set()

    # -- health -------------------------------------------------------------

    def _on_unhealthy_event(self, event: HealthEvent) -> None:
        """Yank the affected devices and republish through the retry
        queue — a failed republish is retried with backoff rather than
        dropped. An explicit `recovered` record re-admits the GPU and
        republishes."""
        recovered = event.kind == RECOVERED_KIND
        mark = (self._state.mark_healthy if recovered
                else self._state.mark_unhealthy)
        if event.gpu_index >= 0:
            affected = mark(event.gpu_index)
        else:
            # gpu_index < 0 addresses every GPU (an event NVML could not
            # tie to one).
            affected = []
            for index in self._state.gpu_indices():
                affected += mark(index)
        if recovered:
            if not affected:
                # Never yanked — or QUARANTINED: the ladder holds the
                # GPU out of the inventory through recovery events
                # (ping-pong is what graduated it); nothing to republish.
                return
            log.info("health recovery (%s): re-admitting devices %s",
                     "all GPUs" if event.gpu_index < 0
                     else f"GPU {event.gpu_index}", affected)
        else:
            log.warning("health event %s (code %d): yanking devices %s",
                        event.kind, event.code, affected)
        self._publish_queue.enqueue(
            None, lambda _obj: self._publish_and_register(), key="publish")

    def clear_quarantine(self, gpu_index: Optional[int] = None) -> List[str]:
        """Operator seam: lift GPU quarantine (None = all) and republish
        the re-admitted devices through the retry queue. Returns the
        re-admitted device names."""
        affected = self._state.clear_quarantine(gpu_index)
        if affected:
            log.info("quarantine cleared (%s): re-admitting devices %s",
                     "all GPUs" if gpu_index is None
                     else f"GPU {gpu_index}", affected)
            self._publish_queue.enqueue(
                None, lambda _obj: self._publish_and_register(),
                key="publish")
        return affected
