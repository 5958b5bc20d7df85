"""End-to-end claim tracing: spans, trace-context propagation, flight
recorder (SURVEY §19).

Every PR so far re-plumbed its own stopwatch keys through the prepare
pipeline by hand; when a claim wedges, the only evidence is scattered
counters. This module is the observability substrate the p99 gates of
the inference-surge and gang-scheduling scenarios will be measured on:

- **Span** / **Tracer** — a dependency-free span layer: trace_id /
  span_id / parent, monotonic timestamps, attributes, status, a
  context-manager API (``with TRACER.span(...)``) plus an explicit
  ``begin``/``end``/``abandon`` API for spans that cross function or
  thread boundaries, and a thread-local current-span stack. dralint
  R12 enforces the begin/end discipline statically; chaos/drmc assert
  zero open spans dynamically at every quiesce/terminal state.
- **W3C-style trace-context propagation** — ``format_traceparent`` /
  ``parse_traceparent`` carry ``00-<32hex>-<16hex>-01`` strings across
  every process boundary the claim crosses: the scheduler stamps one
  into the claim's ``tpu.dev/traceparent`` annotation at allocation,
  the RPC layer re-stamps its own span before handing the claim to
  ``DeviceState.prepare_batch``, the prepare pipeline exports
  ``TPU_DRA_TRACEPARENT`` into the claim CDI env next to
  ``TPU_CHIP_COORDS``, and ``meshexport.plan_from_env`` / the CD
  daemon's readiness mirror close the loop — one claim, one tree from
  ``sched.pod_seen`` through ``mesh.build``.
- **FlightRecorder** — a bounded lock-free ring of recent spans,
  fault-site firings, and workqueue events, dumped to a JSON file when
  the health-monitor wedged gauge sets, a chaos invariant fires, or
  ``SIGUSR1`` arrives — so a wedged claim ships its evidence instead
  of a shrug.

Ownership and hot-path rules:

- The tracer takes **no locks**: span ids come from a GIL-atomic
  counter, the ring is a ``collections.deque(maxlen=...)`` (appends are
  atomic under the GIL), and open-span tracking is plain dict set/del.
  No new lock classes means no new lock-order edges for draracer's
  observed⊆static gate and no new drmc yield points — tracing never
  changes an interleaving.
- ``set_enabled(False)`` keeps timestamps (the bench breakdowns are
  derived from span durations either way) but skips id generation,
  open-span tracking, and ring emission — the perf tier's tracing
  on/off A/B gates the delta at ≤5%.
- The ``trace.emit`` fault site guards emission only: a firing drops
  the span (counted, trace marked dropped) and never breaks the traced
  operation.

Beside the claim tracer sits the **device plane**: named ranges and
counters inside the train step, on torch.profiler's clock, so that every
device operation and idle gap of a profiled step falls under a program
range (``device_span``, names in DEVICE_SPANS) and the MoE router's and
the loss head's work is counted where it happens (``count``, names in
DEVICE_COUNTERS). Its hot-path rules:

- Off (no torch.profiler session recording) a range costs one read of
  the profiler's Python flag and returns one shared no-op context: no
  dispatcher op, no allocation. Counters cost the same read at the call
  site (``recording()``), which skips computing the value.
- On, a range is a RecordFunction of the profiler's function scope
  (``torch._C._profiler._RecordFunctionFast``), so it sits on the clock
  of the CUDA activity. Unlike ``torch.profiler.record_function`` (the
  user scope), it has no mirror on the device's timeline, so the device
  operations a trace lists are the same with and without the ranges. A tensor count is added on its device
  into one preallocated accumulator per device, with no synchronize; an
  int is added on the host. ``read_counters()`` synchronizes once and
  resets.
- This module never imports torch: the control plane imports it, and
  the flag is read from torch's own module where torch is loaded.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Tuple

from tpu_dra_torch.infra import faults as _faults
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DefaultRegistry

# The claim annotation the scheduler stamps at allocation and every
# later hop re-stamps with its own span (W3C propagation: each hop
# overwrites the parent id, the trace id is immutable).
TRACEPARENT_ANNOTATION = "tpu.dev/traceparent"

# The claim CDI env key the prepare pipeline exports next to
# TPU_CHIP_COORDS; workload-side consumers (meshexport.plan_from_env,
# the CD daemon readiness mirror) continue the trace from it.
ENV_TRACEPARENT = "TPU_DRA_TRACEPARENT"

# Flight-recorder ring capacity (events, all kinds). Sized so a whole
# chaos walk or a few hundred claim lifecycles fit without eviction;
# eviction is silent by design — the recorder is recent evidence, not
# an archive.
RING_SIZE = int(os.environ.get("TPU_DRA_FLIGHTRECORDER_RING", "16384"))

SPANS_STARTED = DefaultRegistry.counter(
    "tpu_dra_trace_spans_started_total",
    "spans begun by the claim tracer (id'd spans only: with tracing "
    "disabled spans still time but are neither counted nor emitted)")
SPANS_COMPLETED = DefaultRegistry.counter(
    "tpu_dra_trace_spans_completed_total",
    "spans ended or abandoned and offered to the flight recorder, "
    "labeled by status (ok|error|abandoned)")
SPANS_DROPPED = DefaultRegistry.counter(
    "tpu_dra_trace_spans_dropped_total",
    "completed spans dropped at the emission seam (trace.emit fault "
    "fired); the traced operation is never affected, and the span's "
    "trace is marked so completeness checks skip its structure")
FLIGHT_OCCUPANCY = DefaultRegistry.gauge(
    "tpu_dra_flightrecorder_ring_occupancy",
    "events currently held in the flight-recorder ring (spans + fault "
    "firings + workqueue events), observed at snapshot/dump time")
FLIGHT_DUMPS = DefaultRegistry.counter(
    "tpu_dra_flightrecorder_dumps_total",
    "flight-recorder dumps written, labeled by trigger reason "
    "(wedged|pipeline-wedged|chaos-violation|sigusr1|manual)")


# ---------------------------------------------------------------------------
# Trace-context strings (W3C traceparent shape)
# ---------------------------------------------------------------------------

def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<32hex trace>-<16hex span>-01``; '' for an id-less span."""
    if not trace_id or not span_id:
        return ""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(text: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) or None. Malformed input returns None
    — a torn annotation starts a fresh trace rather than crashing the
    pipeline that carried it (tracing must never break the operation)."""
    if not text:
        return None
    parts = text.split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


# ---------------------------------------------------------------------------
# Span
# ---------------------------------------------------------------------------

class Span:
    """One timed operation. ``end()``/``abandon()`` are idempotent
    (second close is a no-op) and never raise — closes run in finally
    blocks on crash paths."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "status", "attributes", "thread", "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, tracer: "Tracer",
                 attributes: Optional[Dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.status = "open"
        self.attributes = attributes
        self.thread = threading.current_thread().name
        self._tracer = tracer

    # -- timing ---------------------------------------------------------

    @property
    def duration_s(self) -> float:
        """Elapsed seconds; live (now - start) while still open, so
        breakdown derivation can read a phase mid-flight."""
        end = self.end_ns if self.end_ns is not None \
            else time.perf_counter_ns()
        return (end - self.start_ns) / 1e9

    @property
    def duration_ms(self) -> float:
        return self.duration_s * 1e3

    # -- lifecycle ------------------------------------------------------

    def end(self, status: str = "ok") -> None:
        self._tracer._close(self, status)

    def abandon(self, reason: str = "") -> None:
        """Close on an error/crash path: status ``abandoned`` (or
        ``error`` when a reason names the failure). A no-op on an
        already-closed span — crash-path finallys sweep every member
        span, and stamping their reason onto spans that ended cleanly
        would corrupt the very evidence the recorder exists for."""
        if self.end_ns is not None:
            return
        if reason:
            if self.attributes is None:
                self.attributes = {}
            self.attributes.setdefault("error", reason)
            self._tracer._close(self, "error")
        else:
            self._tracer._close(self, "abandoned")

    def set(self, **attributes) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes.update(attributes)

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def to_dict(self) -> Dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "status": self.status, "thread": self.thread,
                "attributes": self.attributes or {}}

    def __repr__(self) -> str:  # debugging / dump readability
        return (f"Span({self.name} {self.trace_id[:8]}/{self.span_id} "
                f"<-{self.parent_id or 'root'} {self.status})")


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of (kind, ...) event tuples: ("span", Span),
    ("fault", site, t_ns), ("wq", queue, op, key, t_ns). Lock-free:
    deque(maxlen) appends are GIL-atomic; eviction of the oldest event
    is silent (recent evidence, not an archive). ``enabled`` gates the
    hot-path recording sites (workqueue ops) together with the tracer's
    enable flag."""

    def __init__(self, maxlen: int = RING_SIZE):
        self._ring: deque = deque(maxlen=maxlen)
        self.enabled = True

    # -- producers ------------------------------------------------------

    def record_span(self, span: Span) -> None:
        self._ring.append(("span", span))

    def record_fault(self, site: str) -> None:
        """Installed as the fault registry's fire observer (below): every
        armed firing lands in the ring next to the spans it perturbed."""
        if self.enabled:
            self._ring.append(("fault", site, time.perf_counter_ns()))

    def record_wq(self, queue: str, op: str, key: str) -> None:
        self._ring.append(("wq", queue, op, key, time.perf_counter_ns()))

    # -- consumers ------------------------------------------------------

    def spans(self) -> List[Span]:
        """Completed spans currently in the ring, oldest first."""
        return [ev[1] for ev in list(self._ring) if ev[0] == "span"]

    def snapshot(self) -> List[Dict]:
        TRACER.sync_metrics()
        events = list(self._ring)
        FLIGHT_OCCUPANCY.set(len(events))
        out: List[Dict] = []
        for ev in events:
            if ev[0] == "span":
                out.append({"kind": "span", **ev[1].to_dict()})
            elif ev[0] == "fault":
                out.append({"kind": "fault", "site": ev[1], "t_ns": ev[2]})
            else:
                out.append({"kind": "wq", "queue": ev[1], "op": ev[2],
                            "key": ev[3], "t_ns": ev[4]})
        return out

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Write the ring (plus any still-open spans, so a wedge's
        culprit is IN the dump) to a JSON file; returns the path. Never
        raises into the trigger path — a dump failure is logged into
        the returned path string instead of crashing a health callback."""
        doc = {
            "reason": reason,
            "wall_time": time.time(),
            "perf_counter_ns": time.perf_counter_ns(),
            "open_spans": [s.to_dict() for s in TRACER.open_spans()],
            "events": self.snapshot(),
        }
        if path is None:
            base = os.environ.get("TPU_DRA_FLIGHTRECORDER_DIR",
                                  tempfile.gettempdir())
            path = os.path.join(
                base, f"tpu-dra-flightrec-{os.getpid()}-"
                      f"{next(_ids):x}.json")
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError as e:
            return f"<dump failed: {e}>"
        FLIGHT_DUMPS.inc(labels={"reason": reason})
        return path

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

# One process-wide id mint: GIL-atomic, deterministic-friendly (drmc
# replays see the same sequence), collision-free within a process —
# which is all the in-process collectors ever compare.
_ids = itertools.count(1)


class _Tally:
    """Lock-free monotone counter for the span hot path: ``bump`` is an
    ``itertools.count`` step (GIL-atomic, never loses an increment);
    the cached ``value`` store races only in visibility, never in the
    count. The registered ``tpu_dra_trace_*`` counters take a lock on
    every inc — acquiring one inside ``begin``/``_close`` would hand
    draracer's static lock-order graph a metric-lock edge under every
    span-wrapped region (a spurious cycle with the checkpoint lock), so
    the hot path tallies here and ``sync_span_metrics`` pushes deltas
    into the registry at observation points (recorder snapshot/dump,
    tests, scrape prep)."""

    __slots__ = ("_next", "value")

    def __init__(self):
        self._next = itertools.count(1).__next__
        self.value = 0

    def bump(self) -> None:
        self.value = self._next()


class Tracer:
    def __init__(self, recorder: FlightRecorder):
        self._recorder = recorder
        self._enabled = True
        self._tally_started = _Tally()
        self._tally_completed = {"ok": _Tally(), "error": _Tally(),
                                 "abandoned": _Tally()}
        self._tally_dropped = _Tally()
        self._synced: Dict[str, int] = {}
        self._sync_lock = threading.Lock()
        # span_id -> Span for every id'd span begun and not yet closed.
        # Plain dict set/del (GIL-atomic); chaos/drmc assert it drains.
        self._open: Dict[str, Span] = {}
        # trace ids with at least one span lost at the emission seam
        # (trace.emit fault): completeness checks skip tree structure
        # for these but still demand zero open spans.
        self._dropped: set = set()
        self._tls = threading.local()

    # -- enable / disable ----------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        """The perf A/B switch: disabled spans still carry timestamps
        (breakdowns keep working) but mint no ids, are not tracked as
        open, and never reach the recorder."""
        self._enabled = bool(on)
        self._recorder.enabled = bool(on)

    # -- begin / end ----------------------------------------------------

    def begin(self, name: str, *, parent: Optional[Span] = None,
              traceparent: Optional[str] = None,
              attributes: Optional[Dict] = None,
              root: bool = False) -> Span:
        """Open a span. Parent resolution, first match wins: explicit
        `parent` span -> `traceparent` string (malformed ⇒ fresh trace)
        -> the thread-local current span (unless `root`) -> fresh
        trace. Every ``begin`` outside a ``with`` must be paired with
        ``end()``/``abandon()`` on all paths — dralint R12."""
        if not self._enabled:
            return Span(name, "", "", "", self, attributes)
        trace_id = parent_id = ""
        if parent is not None and parent.trace_id:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_id = parsed
        if not trace_id and not root:
            cur = self.current()
            if cur is not None and cur.trace_id:
                trace_id, parent_id = cur.trace_id, cur.span_id
        if not trace_id:
            trace_id = f"{next(_ids):032x}"
        span = Span(name, trace_id, f"{next(_ids):016x}", parent_id,
                    self, attributes)
        self._open[span.span_id] = span
        self._tally_started.bump()
        return span

    def end(self, span: Span, status: str = "ok") -> None:
        self._close(span, status)

    def abandon(self, span: Span, reason: str = "") -> None:
        span.abandon(reason)

    def _close(self, span: Span, status: str) -> None:
        if span.end_ns is not None:
            return  # idempotent: crash-path finallys may double-close
        span.end_ns = time.perf_counter_ns()
        span.status = status
        if not span.span_id:
            return  # disabled at begin: timed but never emitted
        self._open.pop(span.span_id, None)
        (self._tally_completed.get(status)
         or self._tally_completed["ok"]).bump()
        # Injection site: emission fails (a real exporter's queue full /
        # serialization error). The span drops, counted, the trace is
        # marked so completeness checks skip its structure — and the
        # traced operation NEVER sees the failure.
        if FAULTS.fires("trace.emit"):
            self._tally_dropped.bump()
            self._dropped.add(span.trace_id)
            if len(self._dropped) > 65536:  # unbounded-growth backstop
                self._dropped.clear()
            return
        self._recorder.record_span(span)

    def sync_metrics(self) -> None:
        """Push the lock-free tallies into the registered counters (see
        _Tally): called at every recorder snapshot/dump and by anything
        about to read the ``tpu_dra_trace_*`` series."""
        pairs = [("started", None, SPANS_STARTED, self._tally_started),
                 ("dropped", None, SPANS_DROPPED, self._tally_dropped)]
        for status, tally in sorted(self._tally_completed.items()):
            pairs.append((f"completed.{status}", {"status": status},
                          SPANS_COMPLETED, tally))
        with self._sync_lock:
            for key, labels, metric, tally in pairs:
                delta = tally.value - self._synced.get(key, 0)
                if delta > 0:
                    metric.inc(delta, labels=labels)
                    self._synced[key] = self._synced.get(key, 0) + delta

    def record_span(self, name: str, duration_s: float, *,
                    parent: Optional[Span] = None,
                    traceparent: Optional[str] = None,
                    attributes: Optional[Dict] = None) -> Span:
        """Synthesize an already-completed span from an externally
        measured duration (e.g. the gRPC handler's decode/encode
        stopwatches, a journal segment shared by a whole batch): start
        is backdated so [start, end] covers the measured window."""
        span = self.begin(name, parent=parent, traceparent=traceparent,
                          attributes=attributes, root=parent is None
                          and traceparent is None)
        self.end(span)
        # Backdate AFTER the close so [start, end] is exactly the
        # measured window (the begin->end gap would otherwise pad it).
        span.start_ns = span.end_ns - int(duration_s * 1e9)
        return span

    # -- context-manager API + thread-local stack -----------------------

    def span(self, name: str, *, parent: Optional[Span] = None,
             traceparent: Optional[str] = None,
             attributes: Optional[Dict] = None, root: bool = False):
        """``with TRACER.span("x") as s:`` — begins, pushes onto this
        thread's current-span stack (nested ``begin``s with no explicit
        parent attach here), ends ``ok`` on normal exit and ``error``
        on exception."""
        return _SpanContext(self, name, parent, traceparent, attributes,
                            root)

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()

    # -- introspection (chaos / drmc / tests) ---------------------------

    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    def open_ids(self) -> FrozenSet[str]:
        """Snapshot of open span ids — harnesses take one at build time
        and assert only NEW spans drained (cross-test leakage of a
        sibling harness must not fail this one)."""
        return frozenset(self._open)

    def open_since(self, snapshot: FrozenSet[str]) -> List[Span]:
        return [s for sid, s in list(self._open.items())
                if sid not in snapshot]

    def trace_spans(self, trace_id: str) -> List[Span]:
        """Completed spans of one trace still in the recorder ring,
        start-ordered, plus any still-open spans of the trace."""
        spans = [s for s in self._recorder.spans()
                 if s.trace_id == trace_id]
        spans += [s for s in self._open.values()
                  if s.trace_id == trace_id]
        return sorted(spans, key=lambda s: s.start_ns)

    def trace_dropped(self, trace_id: str) -> bool:
        return trace_id in self._dropped


class _SpanContext:
    def __init__(self, tracer: Tracer, name: str, parent, traceparent,
                 attributes, root):
        self._tracer = tracer
        self._args = (name, parent, traceparent, attributes, root)
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        name, parent, traceparent, attributes, root = self._args
        self._span = self._tracer.begin(
            name, parent=parent, traceparent=traceparent,
            attributes=attributes, root=root)
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, _tb) -> None:
        span = self._span
        self._tracer._pop(span)
        if exc_type is None:
            span.end()
        else:
            span.abandon(f"{exc_type.__name__}: {exc}")


# ---------------------------------------------------------------------------
# Trace-completeness verification (chaos quiesce, drmc terminal states,
# the e2e structural assertion)
# ---------------------------------------------------------------------------

def verify_trace(trace_id: str, tracer: Optional[Tracer] = None
                 ) -> List[str]:
    """Violations of one trace's completeness contract:

    - **no open spans** — every span of the trace is closed;
    - **parents precede children** — every referenced parent is present
      (spans cross process boundaries conceptually, so containment is
      not required — a scheduler span legitimately ends before the RPC
      span it parents begins) and starts no later than its child;
    - **prepare spans nest under the RPC span** — when the trace has an
      ``rpc.*`` span, every ``prepare.*`` span's ancestry reaches one.

    A trace marked dropped (trace.emit fault fired on one of its spans)
    skips the structural checks — the open-span demand still holds.
    """
    tracer = tracer or TRACER
    spans = tracer.trace_spans(trace_id)
    out: List[str] = []
    if not spans:
        if tracer.trace_dropped(trace_id):
            return out  # EVERY span lost at the emit seam: structure
            # unknowable, and nothing is open — complete by decree.
        return [f"trace {trace_id}: no spans recorded"]
    for s in spans:
        if s.end_ns is None:
            out.append(f"trace {trace_id}: span {s.name} still open")
    if tracer.trace_dropped(trace_id):
        return out  # structure unknowable: a span was dropped at emit
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if not s.parent_id:
            continue
        parent = by_id.get(s.parent_id)
        if parent is None:
            out.append(f"trace {trace_id}: span {s.name} references "
                       f"missing parent {s.parent_id}")
        elif parent.start_ns > s.start_ns:
            out.append(f"trace {trace_id}: parent {parent.name} starts "
                       f"after child {s.name}")
    rpc_ids = {s.span_id for s in spans if s.name.startswith("rpc.")}
    if rpc_ids:
        for s in spans:
            if not s.name.startswith("prepare."):
                continue
            cur, hops = s, 0
            while cur is not None and hops < len(spans) + 1:
                if cur.span_id in rpc_ids:
                    break
                cur = by_id.get(cur.parent_id)
                hops += 1
            else:
                cur = None
            if cur is None:
                out.append(f"trace {trace_id}: prepare span {s.name} "
                           "does not nest under any rpc.* span")
    return out


def span_tree(trace_id: str, tracer: Optional[Tracer] = None
              ) -> Dict[str, List[Span]]:
    """parent span name -> child spans (start-ordered), '' for roots —
    the shape the e2e structural assertion walks."""
    tracer = tracer or TRACER
    out: Dict[str, List[Span]] = {}
    spans = tracer.trace_spans(trace_id)
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        parent = by_id.get(s.parent_id)
        out.setdefault(parent.name if parent else "", []).append(s)
    return out


# ---------------------------------------------------------------------------
# Module singletons + trigger wiring
# ---------------------------------------------------------------------------

RECORDER = FlightRecorder()
TRACER = Tracer(RECORDER)

# Fault firings land in the ring next to the spans they perturbed; the
# hook keeps infra/faults.py dependency-free (no import cycle).
_faults.set_fire_observer(RECORDER.record_fault)


# reason -> monotonic ns of its last dump (the rate-limit ledger for
# triggers that can fire in storms). GIL-atomic dict ops; a racing pair
# of dumps at the window edge is harmless (two files, not thousands).
_last_dump_ns: Dict[str, int] = {}


def dump_flight_recorder(reason: str, path: Optional[str] = None,
                         min_interval_s: float = 0.0) -> str:
    """The one dump entry point every trigger uses: the health monitor's
    wedged branch, the RPC pipeline's wedged-window timeout, chaos's
    any-violation export, SIGUSR1, operators.

    `min_interval_s` rate-limits storm-prone triggers: a wedged
    pipeline fails every retrying RPC for its full timeout, and each
    failure dumping a multi-MB ring would fill the wedged node's tmp
    with identical evidence. Within the window the previous dump is the
    evidence — return a marker instead of a new file."""
    if min_interval_s > 0:
        now = time.monotonic_ns()
        last = _last_dump_ns.get(reason)
        if last is not None and now - last < min_interval_s * 1e9:
            return f"<rate-limited: last {reason} dump " \
                   f"{(now - last) / 1e9:.1f}s ago>"
        _last_dump_ns[reason] = now
    return RECORDER.dump(reason=reason, path=path)


def open_span_violations(snapshot: FrozenSet[str],
                         context: str = "at quiesce") -> List[str]:
    """The zero-open-span invariant, formatted once for every consumer
    (chaos harness quiesce, drmc terminal states): spans begun after
    `snapshot` (``Tracer.open_ids()``) that are still open."""
    return [f"span left open {context}: {s.name} (trace {s.trace_id})"
            for s in TRACER.open_since(snapshot)]


def install_signal_handler(signum: int = signal.SIGUSR1) -> bool:
    """SIGUSR1 -> flight-recorder dump (the 'what is this process doing
    RIGHT NOW' lever for a wedged pod). Main-thread only — returns
    False (no-op) elsewhere so library embedding never crashes."""
    def _handler(_sig, _frame):
        path = dump_flight_recorder("sigusr1")
        print(f"flight recorder dumped to {path}", flush=True)

    try:
        signal.signal(signum, _handler)
    except ValueError:  # not the main thread
        return False
    return True


# ---------------------------------------------------------------------------
# Device plane: the train step's ranges and counters
# ---------------------------------------------------------------------------

# Every range the port opens inside its train step. A device operation
# belongs to the innermost range open when the host launched it.
# moe.dispatch and moe.combine open again in their autograd Functions'
# backward, inside step.backward.
DEVICE_SPANS = (
    "step",            # model.build_train_step's step; arg: its count
    "step.forward",    # loss(model, tokens): embedding, blocks, head, loss
    "step.backward",   # torch.autograd.grad
    "step.sgd",        # the in-place update of every leaf
    "attention.fwd",   # flashattention.attend, every impl
    "attention.bwd",   # _FlashAttention.backward
    "moe.route",       # moe.route_top1, moe.route_topk
    "moe.dispatch",    # moe._experts, topk_ffn: tokens gathered into rows
    "moe.experts",     # the experts' GEMMs and activation
    "moe.combine",     # rows gathered back, gate-scaled (k-way in topk_ffn)
    "mla.project",     # mla.MLA: q, kv_a, kv_b projections, kv norm, rope,
                       # q and k assembled
    "moe.shared",      # moe.topk_ffn: the shared expert
    "loss.head",       # model.lm_loss: the head's GEMM and the loss
    "attention.window",  # mimo_model: a window layer's attend call and
                         # its sink rescale
)

# Every counter: tokens kept within capacity (a device tensor), expert
# slots E x C and tokens routed B x S (host ints), per route_top1 call;
# per route_topk call the held (token, k) pairs, the largest held
# expert's pairs and the tokens with a held pair (device tensors), and
# B x S, the experts held, the (token, k) pairs selected B x S x k and
# the bytes of one token's row in the experts' buffer (host ints); the
# rows of logits the loss head's kernels took, B x (S - 1) per step (a
# host int, per model._FusedNLL call); per sliding-window attention call
# the (query, key) pairs its band holds, B x H x sum of min(i + 1, W), and
# the (Q tile, K tile) pairs the forward kernel visits (host ints, per
# flashattention.attend call with a window).
DEVICE_COUNTERS = ("moe.kept", "moe.slots", "moe.routed", "moe.assigned",
                   "moe.load_max", "moe.tokens_held", "moe.held",
                   "moe.selected", "moe.row_bytes", "loss.fused_rows",
                   "attention.window_pairs", "attention.window_tiles")


class _NoSpan:
    """The one context every range returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def recording() -> bool:
    """Whether a torch.profiler session records now (one flag read)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


def device_span(name: str, arg=None):
    """A range of the train step: a function-scope RecordFunction while a
    profiler session records, else the shared no-op context. `arg` (the
    step's count on ``step``) is the range's keyword input ``arg``, which
    a session with ``record_shapes`` keeps."""
    if not recording():
        return _NO_SPAN
    if name not in DEVICE_SPANS:
        raise ValueError(f"unknown device span {name!r} "
                         f"(have {DEVICE_SPANS})")
    fast = sys.modules["torch"]._C._profiler._RecordFunctionFast
    # Its arguments are checked in C++, where a wrong type aborts the
    # process: no inputs but a list, keyword inputs only as a dict.
    return fast(name) if arg is None else fast(name, [], {"arg": arg})


class DeviceCounters:
    """Counters of DEVICE_COUNTERS: tensor values summed on their device
    into one fp64 vector per device, ints on the host."""

    def __init__(self):
        self._acc: Dict[Any, Any] = {}      # device -> fp64 [len(names)]
        self._on_device: set = set()        # names counted there
        self._host: Dict[str, int] = {}

    def add(self, name: str, value) -> None:
        if name not in DEVICE_COUNTERS:
            raise ValueError(f"unknown counter {name!r} "
                             f"(have {DEVICE_COUNTERS})")
        if isinstance(value, int):
            self._host[name] = self._host.get(name, 0) + value
            return
        acc = self._acc.get(value.device)
        if acc is None:
            acc = value.new_zeros(len(DEVICE_COUNTERS),
                                  dtype=sys.modules["torch"].float64)
            self._acc[value.device] = acc
        acc[DEVICE_COUNTERS.index(name)].add_(value.detach())
        self._on_device.add(name)

    def read(self) -> Dict[str, float]:
        """{name: number} of every counter counted since the last read
        (one synchronize per device holding counts), then all zero."""
        out: Dict[str, float] = dict(self._host)
        for acc in self._acc.values():
            for name, value in zip(DEVICE_COUNTERS, acc.tolist()):
                if name in self._on_device:
                    out[name] = out.get(name, 0) + value
            acc.zero_()
        self._host.clear()
        self._on_device.clear()
        return out


DEVICE_COUNTS = DeviceCounters()


def count(name: str, value) -> None:
    """Add `value` (a tensor, summed on its device, or an int) to counter
    `name` while a profiler session records; nothing otherwise. Compute
    a tensor value only under ``recording()``."""
    if recording():
        DEVICE_COUNTS.add(name, value)


def read_counters() -> Dict[str, float]:
    """The device plane's counts since the last read; resets them."""
    return DEVICE_COUNTS.read()
