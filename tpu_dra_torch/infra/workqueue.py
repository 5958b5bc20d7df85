"""Rate-limited work queue with per-key latest-wins retry semantics
(counterpart of tpu_dra/infra/workqueue.py, cut to what the kubelet
plugin's ResourceSlice publish queue uses).

Retryable callbacks are enqueued with a key; when a newer item is
enqueued under the same key, a *failed* older item is forgotten instead
of retried (supersede). Rate limiting combines per-item exponential
backoff with a global token bucket (``default_prep_unprep_rate_limiter``).
One consumer thread (``run``/``run_in_thread``) processes the items.

Not copied: the reference's worker pools and their per-key
serialization, the ``dedupe`` enqueue, the queue-depth gauges, the
model checker's scheduling hooks and the controller and daemon rate
limiters. They come with the slices that run them.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from tpu_dra_torch.infra.trace import RECORDER as _FLIGHTREC


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


def default_prep_unprep_rate_limiter() -> RateLimiter:
    """250ms–3s per-item expo + global 5/s bucket with burst 10."""
    return MaxOfRateLimiter(
        ExponentialFailureRateLimiter(0.250, 3.0),
        BucketRateLimiter(qps=5, burst=10),
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


class WorkQueue:
    """Threaded delay queue; run() processes items until shutdown().

    Failed callbacks (those that raise) are re-enqueued rate-limited unless a
    newer item with the same key has been enqueued since — then the failure
    is forgotten ("latest wins"). Exceptions raised by callbacks are treated
    as expected retryable errors in an eventually consistent system and not
    re-raised.
    """

    def __init__(self, rate_limiter: Optional[RateLimiter] = None):
        self._rl = rate_limiter or default_prep_unprep_rate_limiter()
        self._heap: list = []  # (ready_at, seq, WorkItem)
        self._seq = itertools.count()
        self._cond = threading.Condition(threading.Lock())
        self._active_ops: Dict[str, WorkItem] = {}
        self._shutdown = False

    # -- producers ----------------------------------------------------------

    def enqueue(self, obj: Any, callback: Callable[[Any], None],
                key: str = "") -> None:
        if _FLIGHTREC.enabled:
            # Queue events are flight-recorder evidence: a wedge dump
            # shows what was queued when. Recorded outside _cond.
            _FLIGHTREC.record_wq("?", "add", key)
        with self._cond:
            item = WorkItem(key=key, obj=obj, callback=callback)
            if key:
                self._active_ops[key] = item
            self._push_locked(item)
            self._cond.notify()

    def _push_locked(self, item: WorkItem) -> None:
        delay = self._rl.when(item.item_id)
        heapq.heappush(self._heap, (time.monotonic() + delay, next(self._seq), item))

    # -- consumer -----------------------------------------------------------

    def run(self) -> None:
        """Process items until shutdown()."""
        while True:
            item = self._get()
            if item is None:
                return
            self._process(item)

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True, name="workqueue")
        t.start()
        return t

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def _get(self) -> Optional[WorkItem]:
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                now = time.monotonic()
                if self._heap and self._heap[0][0] <= now:
                    return heapq.heappop(self._heap)[2]
                if self._heap:
                    self._cond.wait(timeout=min(self._heap[0][0] - now, 0.5))
                else:
                    self._cond.wait(timeout=0.5)

    def _process(self, item: WorkItem) -> None:
        if _FLIGHTREC.enabled:
            _FLIGHTREC.record_wq("?", "get", item.key)
        try:
            item.callback(item.obj)
        except Exception:  # noqa: BLE001 — retryable by contract
            with self._cond:
                current = self._active_ops.get(item.key)
                if item.key and current is not item:
                    # Superseded: a newer item under this key is still
                    # pending, or already completed (success deletes the
                    # entry). Either way this failure is obsolete.
                    self._rl.forget(item.item_id)
                else:
                    self._push_locked(item)
                    self._cond.notify()
            return
        with self._cond:
            if item.key and self._active_ops.get(item.key) is item:
                del self._active_ops[item.key]
            self._rl.forget(item.item_id)
