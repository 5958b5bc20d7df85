"""Rate-limited work queue with per-key latest-wins retry semantics
(counterpart of tpu_dra/infra/workqueue.py, cut to what the kubelet
plugin's ResourceSlice publish queue uses).

Retryable callbacks are enqueued with a key; when a newer item is
enqueued under the same key, a *failed* older item is forgotten instead
of retried (supersede). Rate limiting combines per-item exponential
backoff with a global token bucket (``default_prep_unprep_rate_limiter``).
One consumer thread (``run``/``run_in_thread``) processes the items, or
a pool of them (``start_workers``).

The compute-domain stack adds the controller's and the domain daemon's
rate limiters (``default_controller_rate_limiter``,
``default_cd_daemon_rate_limiter``, with ``JitterRateLimiter``) and the
``after`` enqueue for time-based re-evaluation; the sim scheduler adds
the ``dedupe`` enqueue (a waiting item of the same key absorbs it).

**Worker pools:** ``start_workers(n)`` runs N consumer threads against
one queue with client-go's parallelism contract: two items sharing a key
are never processed at once. A ready item whose key is mid-process on
another worker is *deferred* (parked in a per-key side list, still
absorbing ``dedupe=True`` enqueues, since it has not run yet) and
re-queued the moment the in-flight item completes, so per-key order is
kept. Keyless items are never serialized. One worker (``run()``) is the
single-consumer behaviour exactly. A named queue (``name=``) exports its
depth and busy workers as the ``tpu_dra_workqueue_depth`` and
``tpu_dra_workqueue_busy_workers`` gauges.

**Model-checker hooks:** ``set_drmc_hooks`` lets the port's drmc
(``tpu_dra_torch.analysis.drmc``) virtualize the queue's condition
variable for the threads it schedules and see enqueue/pop as yield
points. Threads it does not control fall through to the real
``Condition``.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from tpu_dra_torch.infra.trace import RECORDER as _FLIGHTREC


# ---------------------------------------------------------------------------
# drmc seam (tpu_dra_torch/analysis/drmc): deterministic-scheduler hooks
# ---------------------------------------------------------------------------
# When installed, the model checker virtualizes the queue's condition
# variable for threads under controlled scheduling — wait() parks the
# task in the scheduler's model (a timed wait can always wake, so a
# waiting task stays schedulable as a timeout when nothing else can
# run) and notify() wakes modeled waiters — and sees enqueue/pop as
# yield points carrying the item key (the DPOR conflict label).
# Uncontrolled threads fall through to the real Condition, so a live
# process with a checker installed elsewhere keeps working.

_drmc = None


def set_drmc_hooks(hooks) -> None:
    global _drmc
    _drmc = hooks


def clear_drmc_hooks() -> None:
    global _drmc
    _drmc = None


# ---------------------------------------------------------------------------
# Rate limiters
# ---------------------------------------------------------------------------

class RateLimiter:
    def when(self, item_id: int) -> float:
        """Seconds to wait before (re)processing this item."""
        raise NotImplementedError

    def forget(self, item_id: int) -> None:
        pass


class ExponentialFailureRateLimiter(RateLimiter):
    """Per-item exponential backoff: base * 2^failures, capped."""

    def __init__(self, base_delay: float, max_delay: float):
        self._base = base_delay
        self._max = max_delay
        self._failures: Dict[int, int] = {}
        self._lock = threading.Lock()

    def when(self, item_id: int) -> float:
        with self._lock:
            n = self._failures.get(item_id, 0)
            self._failures[item_id] = n + 1
        return min(self._base * (2 ** n), self._max)

    def forget(self, item_id: int) -> None:
        with self._lock:
            self._failures.pop(item_id, None)


class BucketRateLimiter(RateLimiter):
    """Global token bucket: `qps` refills/s, `burst` capacity; when()
    reserves a token and returns the wait."""

    def __init__(self, qps: float, burst: int):
        self._qps = qps
        self._burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def when(self, item_id: int) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._burst, self._tokens + (now - self._last) * self._qps)
            self._last = now
            self._tokens -= 1.0
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self._qps


class MaxOfRateLimiter(RateLimiter):
    """Pick the longest delay among limiters."""

    def __init__(self, *limiters: RateLimiter):
        self._limiters = limiters

    def when(self, item_id: int) -> float:
        return max(l.when(item_id) for l in self._limiters)

    def forget(self, item_id: int) -> None:
        for l in self._limiters:
            l.forget(item_id)


class JitterRateLimiter(RateLimiter):
    """Wrap an inner limiter with +/- factor/2 relative jitter."""

    def __init__(self, inner: RateLimiter, factor: float):
        if factor >= 1.0:
            raise ValueError("jitter factor must be < 1.0")
        self._inner = inner
        self._factor = factor

    def when(self, item_id: int) -> float:
        d = self._inner.when(item_id)
        return max(0.0, d + d * self._factor * (random.random() - 0.5))

    def forget(self, item_id: int) -> None:
        self._inner.forget(item_id)


def default_prep_unprep_rate_limiter() -> RateLimiter:
    """250ms–3s per-item expo + global 5/s bucket with burst 10."""
    return MaxOfRateLimiter(
        ExponentialFailureRateLimiter(0.250, 3.0),
        BucketRateLimiter(qps=5, burst=10),
    )


def default_cd_daemon_rate_limiter() -> RateLimiter:
    """5ms–6s expo with 0.5 relative jitter (the domain daemon's retries
    and the CD plugin's readiness ladder)."""
    return JitterRateLimiter(ExponentialFailureRateLimiter(0.005, 6.0), 0.5)


def default_controller_rate_limiter() -> RateLimiter:
    """client-go's default controller limiter: 5ms–1000s expo + 10/s
    bucket with burst 100."""
    return MaxOfRateLimiter(
        ExponentialFailureRateLimiter(0.005, 1000.0),
        BucketRateLimiter(qps=10, burst=100),
    )


# ---------------------------------------------------------------------------
# Work queue
# ---------------------------------------------------------------------------

@dataclass
class WorkItem:
    key: str
    obj: Any
    callback: Callable[[Any], None]
    item_id: int = field(default_factory=itertools.count().__next__)
    # Counted in WorkQueue._queued_keys while it waits (a first enqueue
    # with a key; never a failure's retry).
    counted: bool = False


class WorkQueue:
    """Threaded delay queue; run() processes items until shutdown().

    Failed callbacks (those that raise) are re-enqueued rate-limited unless a
    newer item with the same key has been enqueued since — then the failure
    is forgotten ("latest wins"). Exceptions raised by callbacks are treated
    as expected retryable errors in an eventually consistent system and not
    re-raised.
    """

    def __init__(self, rate_limiter: Optional[RateLimiter] = None,
                 log: Optional[Callable[[str], None]] = None,
                 name: str = ""):
        self._rl = rate_limiter or default_prep_unprep_rate_limiter()
        self._heap: list = []  # (ready_at, seq, WorkItem)
        self._seq = itertools.count()
        # An explicit Lock created here (not the RLock a bare Condition
        # makes inside threading's own frame), so the lock-order witness
        # sees the queue's critical sections.
        self._cond = threading.Condition(threading.Lock())
        self._active_ops: Dict[str, WorkItem] = {}
        # key -> items of that key still queued (in the heap or deferred,
        # not yet handed to a worker); backs dedupe=True.
        self._queued_keys: Dict[str, int] = {}
        # Per-key serialization for worker pools: the keys a worker is
        # processing now, and ready items deferred behind them.
        self._processing: Dict[str, WorkItem] = {}
        self._deferred: Dict[str, list] = {}
        self._busy = 0
        self._shutdown = False
        self._log = log or (lambda msg: None)
        # Named queues export depth/busy-worker gauges (unnamed ones,
        # short-lived fixtures, stay out of the registry's labels).
        self._name = name
        self._depth_gauge = self._busy_gauge = None
        if name:
            from tpu_dra_torch.infra.metrics import (
                WORKQUEUE_BUSY, WORKQUEUE_DEPTH,
            )
            self._depth_gauge = WORKQUEUE_DEPTH
            self._busy_gauge = WORKQUEUE_BUSY

    # -- producers ----------------------------------------------------------

    def enqueue(self, obj: Any, callback: Callable[[Any], None],
                key: str = "", after: Optional[float] = None,
                dedupe: bool = False) -> None:
        """after: explicit delay in seconds, overriding the rate limiter —
        for time-based re-evaluation (settle windows) rather than failure
        backoff.

        dedupe=True: a key already waiting in the queue absorbs the
        enqueue (the waiting item sees the latest state when it runs);
        a key being processed enqueues normally, so a change racing the
        reconcile is never lost."""
        if _FLIGHTREC.enabled:
            # Queue events are flight-recorder evidence: a wedge dump
            # shows what was queued when. Recorded outside _cond.
            _FLIGHTREC.record_wq(self._name or "?", "add", key)
        with self._cond:
            self._yield_op("queue.add", key)
            if dedupe and key and self._queued_keys.get(key, 0) > 0:
                return
            item = WorkItem(key=key, obj=obj, callback=callback)
            if key:
                self._active_ops[key] = item
                item.counted = True
                self._queued_keys[key] = self._queued_keys.get(key, 0) + 1
            self._push_locked(item, after=after)
            self._observe_locked()
            self._notify()

    def _push_locked(self, item: WorkItem,
                     after: Optional[float] = None) -> None:
        delay = self._rl.when(item.item_id) if after is None else after
        heapq.heappush(self._heap, (time.monotonic() + delay, next(self._seq), item))

    # -- drmc indirections ---------------------------------------------------

    def _yield_op(self, kind: str, key: str) -> None:
        hooks = _drmc
        if hooks is not None:
            hooks.yield_op(kind, key)

    def _notify(self, all_waiters: bool = False) -> None:
        hooks = _drmc
        if hooks is not None and hooks.notify(self._cond, all_waiters):
            return
        if all_waiters:
            self._cond.notify_all()
        else:
            self._cond.notify()

    def _wait(self, timeout: float) -> None:
        hooks = _drmc
        if hooks is not None and hooks.wait(self._cond, timeout):
            return
        self._cond.wait(timeout=timeout)

    # -- consumer -----------------------------------------------------------

    def run(self, stop_event: Optional[threading.Event] = None) -> None:
        """Process items until shutdown() (or stop_event set)."""
        while True:
            item = self._get(stop_event)
            if item is None:
                return
            self._process(item)

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True, name="workqueue")
        t.start()
        return t

    def start_workers(self, n: int,
                      stop_event: Optional[threading.Event] = None
                      ) -> list:
        """The worker pool: N consumer threads over this queue with
        per-key serialization (module docstring). Returns the threads;
        join them after shutdown()/stop_event for a clean stop."""
        threads = []
        for i in range(n):
            t = threading.Thread(target=self.run, args=(stop_event,),
                                 daemon=True,
                                 name=f"workqueue-{self._name or 'pool'}-{i}")
            t.start()
            threads.append(t)
        return threads

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._notify(all_waiters=True)

    def _get(self, stop_event: Optional[threading.Event] = None
             ) -> Optional[WorkItem]:
        with self._cond:
            while True:
                if self._shutdown or (stop_event is not None
                                      and stop_event.is_set()):
                    return None
                now = time.monotonic()
                handed = None
                while self._heap and self._heap[0][0] <= now:
                    _, _, item = heapq.heappop(self._heap)
                    if item.key and item.key in self._processing:
                        # Per-key serialization: the key is mid-process on
                        # another worker. Defer; the item keeps its dedupe
                        # registration (it has not run) and is re-queued
                        # when the in-flight item completes.
                        self._deferred.setdefault(item.key, []).append(item)
                        continue
                    handed = item
                    break
                if handed is not None:
                    self._yield_op("queue.get", handed.key)
                    if handed.key:
                        self._processing[handed.key] = handed
                        if handed.counted:
                            # A retry's re-push stays uncounted: dedupe
                            # must not absorb into it.
                            handed.counted = False
                            n = self._queued_keys.pop(handed.key) - 1
                            if n:
                                self._queued_keys[handed.key] = n
                    self._busy += 1
                    self._observe_locked()
                    return handed
                if self._heap:
                    self._wait(min(self._heap[0][0] - now, 0.5))
                else:
                    self._wait(0.5)

    def _release_key_locked(self, item: WorkItem) -> None:
        """End of this item's processing: free its key and re-queue the
        ready items deferred behind it (one notify each, so idle pool
        workers pick them up at once)."""
        self._busy -= 1
        if item.key:
            if self._processing.get(item.key) is item:
                del self._processing[item.key]
            for deferred in self._deferred.pop(item.key, ()):
                heapq.heappush(self._heap,
                               (time.monotonic(), next(self._seq), deferred))
                self._notify()
        self._observe_locked()

    def _process(self, item: WorkItem) -> None:
        if _FLIGHTREC.enabled:
            _FLIGHTREC.record_wq(self._name or "?", "get", item.key)
        try:
            item.callback(item.obj)
        except Exception as e:  # noqa: BLE001 — retryable by contract
            self._log(f"reconcile: {e}")
            with self._cond:
                self._release_key_locked(item)
                current = self._active_ops.get(item.key)
                if item.key and current is not item:
                    # Superseded: a newer item under this key is still
                    # pending, or already completed (success deletes the
                    # entry). Either way this failure is obsolete.
                    self._log(f"not re-enqueueing '{item.key}': superseded")
                    self._rl.forget(item.item_id)
                else:
                    self._push_locked(item)
                    self._notify()
            return
        with self._cond:
            self._release_key_locked(item)
            if item.key and self._active_ops.get(item.key) is item:
                del self._active_ops[item.key]
            self._rl.forget(item.item_id)

    def _observe_locked(self) -> None:
        if self._depth_gauge is not None:
            labels = {"queue": self._name}
            self._depth_gauge.set(
                len(self._heap) + sum(len(v) for v in
                                      self._deferred.values()),
                labels=labels)
            self._busy_gauge.set(self._busy, labels=labels)
