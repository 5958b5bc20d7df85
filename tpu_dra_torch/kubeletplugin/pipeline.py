"""Pipelined RPC admission: bounded in-flight window + keyed ordering
(counterpart of tpu_dra/kubeletplugin/pipeline.py, copied as it is).

The DRA server hands every RPC to an executor thread; what makes them a
*pipeline* is how little of each RPC is exclusive. This module owns the
two pieces the server/driver pair needs for that:

- **Bounded in-flight window** — at most `window` RPCs past admission
  at once (kubelet retry storms and chaos harnesses must not pile
  unbounded threads onto the claim-fetch fan-out), with the current
  depth exported as ``tpu_dra_prepare_inflight_rpcs``.

- **Per-claim-set keyed serialization** — two RPCs touching the same
  claim uid never reorder: each admitted RPC registers a completion
  gate per uid and waits for the gates of every predecessor holding one
  of its uids. RPCs on disjoint claim sets proceed concurrently — the
  whole point: while RPC N sits in its commit fdatasync, RPC N+1 is
  decoding and claim-fetching. The waits-for graph follows registration
  order, so it is acyclic by construction (no deadlock).

Ordering + the window compose safely: gates are registered at
admission, and an admitted RPC only ever waits on gates registered
BEFORE its own, whose owners are admitted and will complete.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List

from tpu_dra_torch.infra.faults import FAULTS, FaultInjected
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.infra.trace import dump_flight_recorder

INFLIGHT_RPCS = DefaultRegistry.gauge(
    "tpu_dra_prepare_inflight_rpcs",
    "prepare/unprepare RPCs currently admitted into the pipelined "
    "server (bounded by the in-flight window)")

RPC_DRAIN_SECONDS = DefaultRegistry.histogram(
    "tpu_dra_rpc_drain_seconds",
    "time the hot-restart drain window spent waiting for in-flight "
    "RPCs to finish (SURVEY §22: the shutdown half of the "
    "zero-failed-RPC restart contract)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0))


class _Ticket:
    """One admitted RPC: its completion gate plus the predecessor gates
    it must wait out before touching driver state."""

    def __init__(self, uids: List[str], gate: threading.Event,
                 predecessors: List[threading.Event]):
        self.uids = uids
        self.gate = gate
        self.predecessors = predecessors
        self.queue_s = 0.0  # admission wait + predecessor wait


class PipelineTimeout(TimeoutError):
    pass


class PipelineDraining(RuntimeError):
    """Raised at admission while the plugin is draining for a hot
    restart. Deliberately NOT a TimeoutError/FaultInjected: the driver
    maps those to per-claim errors, but a draining plugin must fail the
    RPC at the transport (METHOD_ERROR / gRPC error) so the client's
    retry-on-reconnect masks the restart — the zero-failed-RPC
    contract (SURVEY §22)."""


class RpcPipeline:
    # Fail-fast bound on queueing (admission + ordering): a wedged
    # predecessor RPC must surface as THIS RPC's error for kubelet to
    # retry, not wedge the whole plugin silently — the bound the
    # pre-pipeline per-RPC flock timeout used to provide.
    DEFAULT_TIMEOUT_S = 30.0

    def __init__(self, window: int = 16,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self._window = threading.Semaphore(window)
        self._timeout_s = timeout_s
        self._gates_lock = threading.Lock()
        # uid -> the gate of the LAST admitted RPC touching it.
        self._last_gate: Dict[str, threading.Event] = {}
        self._inflight = 0
        # Hot-restart drain: once set, admit() refuses new RPCs while
        # drain() waits (on _cv, notified by done()) for the admitted
        # ones to finish.
        self._draining = threading.Event()
        self._cv = threading.Condition(self._gates_lock)

    def admit(self, uids: Iterable[str]) -> _Ticket:
        """Block for a window slot (bounded), then register this RPC's
        gates. Registration order IS the serialization order for
        overlapping claim sets. Raises PipelineTimeout when the window
        never frees — the caller fails the RPC."""
        unique = list(dict.fromkeys(uids))
        if self._draining.is_set():
            # Refused BEFORE any slot/gate exists to leak. Propagates
            # past the driver's per-claim error mapping to the
            # transport, where the retrying client waits out the
            # restart.
            raise PipelineDraining(
                "plugin draining for hot restart; retry after reconnect")
        # Injection site for the async front-end's admission path
        # (SURVEY §21): an admission refusal must fail THIS RPC with a
        # per-claim error (kubelet retries) before any window slot or
        # gate registration exists to leak — the chaos prepare walk
        # arms it against exactly that invariant.
        FAULTS.check("prepare.rpc_admit", uids=unique)
        t0 = time.perf_counter()
        if not self._window.acquire(timeout=self._timeout_s):
            # A window that never frees means in-flight RPCs are wedged
            # somewhere past admission — exactly the moment the flight
            # recorder's evidence (open spans name the stuck stage and
            # thread) matters. Dump before failing the RPC (SURVEY
            # §19.3); the dump never raises, and it is rate-limited —
            # a sustained wedge fails every retrying RPC, and each one
            # writing a fresh multi-MB ring would fill the wedged
            # node's tmp with identical evidence.
            dump_path = dump_flight_recorder("pipeline-wedged",
                                             min_interval_s=60.0)
            raise PipelineTimeout(
                f"prepare pipeline window full for {self._timeout_s}s "
                "(in-flight RPCs wedged?); flight recorder dumped to "
                f"{dump_path}")
        gate = threading.Event()
        with self._gates_lock:
            predecessors = [self._last_gate[u] for u in unique
                            if u in self._last_gate]
            for u in unique:
                self._last_gate[u] = gate
            self._inflight += 1
            INFLIGHT_RPCS.set(self._inflight)
        ticket = _Ticket(unique, gate, predecessors)
        ticket.queue_s = time.perf_counter() - t0
        return ticket

    def order(self, ticket: _Ticket) -> None:
        """Wait (bounded) for every predecessor RPC sharing a claim
        uid. Call after any prefetch work that may overlap (the claim
        fan-out reads the API server, not driver state) and before
        touching DeviceState. Raises PipelineTimeout on a wedged
        predecessor; the caller must still done() its ticket."""
        t0 = time.perf_counter()
        deadline = t0 + self._timeout_s
        for gate in ticket.predecessors:
            if not gate.wait(timeout=max(0.0, deadline
                                         - time.perf_counter())):
                ticket.queue_s += time.perf_counter() - t0
                raise PipelineTimeout(
                    f"predecessor RPC on a shared claim still running "
                    f"after {self._timeout_s}s")
        ticket.queue_s += time.perf_counter() - t0

    def done(self, ticket: _Ticket) -> None:
        """Release the RPC: open its gate for successors, drop its
        uid registrations (only where it is still the latest), free the
        window slot. Always runs (finally) — an RPC that errors must
        not wedge its successors."""
        ticket.gate.set()
        with self._gates_lock:
            for u in ticket.uids:
                if self._last_gate.get(u) is ticket.gate:
                    del self._last_gate[u]
            self._inflight -= 1
            INFLIGHT_RPCS.set(self._inflight)
            if self._inflight == 0:
                self._cv.notify_all()  # a drain may be waiting
        self._window.release()

    def drain(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> float:
        """Stop admitting and wait (bounded) for every in-flight RPC to
        finish — the shutdown half of the hot-restart contract: work
        past admission completes and commits (the journal barrier runs
        after this), work not yet admitted is refused for the client to
        retry against the next incarnation. Returns the seconds spent
        waiting; observed into ``tpu_dra_rpc_drain_seconds``. A drain
        that times out with RPCs still in flight dumps the flight
        recorder (the evidence names the stuck stage) and returns — the
        journal + idempotent prepare make the cut-off recoverable."""
        self._draining.set()
        t0 = time.perf_counter()
        try:
            # Injection site: the drain window itself wedges (an
            # in-flight RPC never completes). Declared degradation:
            # dump_flight_recorder — evidence out before the process
            # goes down.
            FAULTS.check("prepare.drain")
            deadline = t0 + timeout_s
            with self._cv:
                while self._inflight > 0:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0.0:
                        break
                    self._cv.wait(timeout=remaining)
                stuck = self._inflight
            if stuck:
                dump_flight_recorder("drain-timeout", min_interval_s=60.0)
        except FaultInjected:
            dump_flight_recorder("drain-faulted", min_interval_s=60.0)
        elapsed = time.perf_counter() - t0
        RPC_DRAIN_SECONDS.observe(elapsed)
        return elapsed

    @property
    def draining(self) -> bool:
        return self._draining.is_set()
