"""The port's work-queue worker pools (tpu_dra_torch.infra.workqueue
.WorkQueue.start_workers) against the reference's
(tpu_dra.infra.workqueue).

TestWorkQueuePool is tests/test_infra.py's class of that name run on the
port: per-key serialization checked with the port's lock witness
installed (tpu_dra_torch.infra.lockwitness), dedupe across the pool,
keyless items in parallel, a named queue's depth/busy gauges
(tpu_dra_torch.infra.metrics), and the one-worker pool as run(). Then
parity: one keyed enqueue script (immediate and delayed items, repeated
keys, dedupe absorption, a keyless item and a failure's retry) through a
one-worker pool of each package processes the same items in the same
order (exact).
"""

import threading
import time

from tpu_dra_torch.infra import lockwitness
from tpu_dra_torch.infra.workqueue import (
    ExponentialFailureRateLimiter, WorkQueue,
)


class FastRL(ExponentialFailureRateLimiter):
    def __init__(self):
        super().__init__(0.001, 0.005)


class TestWorkQueuePool:
    """The multi-worker pool's client-go parallelism contract: N
    consumers, per-key serialization, dedupe preserved."""

    def _drain(self, q, threads):
        q.shutdown()
        for t in threads:
            t.join(3)
            assert not t.is_alive()

    def test_per_key_items_never_overlap_witnessed(self):
        """Two items sharing a key must never be mid-callback on two
        workers at once — asserted by an overlap probe across a keyed
        item storm, with the port's lock-order witness installed so the
        pool's own locking discipline is checked in the same run."""
        lockwitness.install()
        try:
            snap = lockwitness.WITNESS.snapshot()
            q = WorkQueue(FastRL())
            assert isinstance(q._cond._lock, lockwitness.WitnessLock)
            active = {}
            overlaps = []
            done = []
            probe = threading.Lock()

            def cb_for(key):
                def cb(_obj):
                    with probe:
                        active[key] = active.get(key, 0) + 1
                        if active[key] > 1:
                            overlaps.append(key)
                    time.sleep(0.002)  # widen the overlap window
                    with probe:
                        active[key] -= 1
                        done.append(key)
                return cb

            threads = q.start_workers(4)
            # 3 keys x 8 rounds, no dedupe: every item runs; same-key
            # items must strictly serialize across the 4 workers.
            for _ in range(8):
                for key in ("a", "b", "c"):
                    q.enqueue(None, cb_for(key), key=key)
                time.sleep(0.004)
            deadline = time.monotonic() + 5
            while len(done) < 24 and time.monotonic() < deadline:
                time.sleep(0.01)
            self._drain(q, threads)
            assert len(done) == 24, f"only {len(done)}/24 items ran"
            assert overlaps == [], f"per-key overlap on {set(overlaps)}"
            assert lockwitness.WITNESS.violations_since(snap) == []
        finally:
            lockwitness.uninstall()

    def test_dedupe_survives_pool(self):
        """client-go Add() semantics under N>1 workers: items absorb
        into a QUEUED same-key item (even one deferred behind an
        in-flight callback) but never into the in-flight one."""
        q = WorkQueue(FastRL())
        release = threading.Event()
        runs = []

        def slow(_obj):
            runs.append("slow")
            assert release.wait(3)

        def fast(_obj):
            runs.append("fast")

        threads = q.start_workers(3)
        q.enqueue(None, slow, key="k", dedupe=True)
        deadline = time.monotonic() + 3
        while not runs and time.monotonic() < deadline:
            time.sleep(0.005)
        assert runs == ["slow"]  # first item is mid-flight
        # Mid-flight: this one must NOT absorb (the change would be
        # lost) — it queues behind, deferred while "k" is processing.
        q.enqueue(None, fast, key="k", dedupe=True)
        time.sleep(0.05)
        # Queued/deferred: these MUST absorb into the queued item.
        for _ in range(5):
            q.enqueue(None, fast, key="k", dedupe=True)
        assert runs == ["slow"], "deferred item ran while key in flight"
        release.set()
        deadline = time.monotonic() + 3
        while len(runs) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.1)  # absorbed items would surface by now
        self._drain(q, threads)
        assert runs == ["slow", "fast"], runs

    def test_keyless_items_run_concurrently(self):
        """Keyless items are never serialized: two of them must be
        in-flight simultaneously on a 2-worker pool."""
        q = WorkQueue(FastRL())
        both = threading.Barrier(2, timeout=3)
        met = []

        def cb(_obj):
            both.wait()  # only passes if BOTH are mid-flight at once
            met.append(1)

        threads = q.start_workers(2)
        q.enqueue(None, cb)
        q.enqueue(None, cb)
        deadline = time.monotonic() + 3
        while len(met) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        self._drain(q, threads)
        assert len(met) == 2, "keyless items did not overlap on the pool"

    def test_named_queue_gauges_track_keyless_items(self):
        """depth/busy gauges must observe enqueue and keyless-item
        completion, not only keyed pops — a busy gauge stuck after a
        keyless callback misreports an idle pool as loaded."""
        from tpu_dra_torch.infra.metrics import (
            WORKQUEUE_BUSY, WORKQUEUE_DEPTH,
        )
        labels = {"queue": "gauge-test"}
        q = WorkQueue(FastRL(), name="gauge-test")
        ran = threading.Event()
        q.enqueue(None, lambda _obj: ran.set(), after=5.0)  # parked
        assert WORKQUEUE_DEPTH.value(labels=labels) == 1
        threads = q.start_workers(1)
        keyless_done = threading.Event()
        q.enqueue(None, lambda _obj: keyless_done.set())  # runs now
        assert keyless_done.wait(3)
        deadline = time.monotonic() + 3
        while (WORKQUEUE_BUSY.value(labels=labels) != 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert WORKQUEUE_BUSY.value(labels=labels) == 0, \
            "busy gauge stuck after keyless completion"
        assert WORKQUEUE_DEPTH.value(labels=labels) == 1  # still parked
        self._drain(q, threads)
        assert not ran.is_set()

    def test_single_worker_pool_matches_run_semantics(self):
        """start_workers(1) degenerates to run(): items process in
        ready order, retries still back off."""
        q = WorkQueue(FastRL())
        seen = []
        done = threading.Event()

        def cb(obj):
            seen.append(obj)
            if len(seen) == 3:
                done.set()

        threads = q.start_workers(1)
        for i in range(3):
            q.enqueue(i, cb, key=f"k{i}")
        assert done.wait(3)
        self._drain(q, threads)
        assert seen == [0, 1, 2]


def _script_order(queue_cls, rl_cls):
    """Run the enqueue script through a one-worker pool of `queue_cls`;
    return the processing order as (tag, key) pairs."""
    q = queue_cls(rl_cls())
    order = []
    done = threading.Event()
    failed_once = []

    def cb_for(tag, key):
        def cb(_obj):
            order.append((tag, key))
            if tag == "flaky" and not failed_once:
                failed_once.append(1)
                raise RuntimeError("transient")
            if tag == "last":
                done.set()
        return cb

    script = [  # (tag, key, after, dedupe)
        ("a1", "a", 0, True), ("b1", "b", 0, True),
        ("a2", "a", 0, True),            # absorbed: "a" still queued
        ("x", "", 0, False),             # keyless
        ("flaky", "f", 0, False),        # fails once, retried
        ("c1", "c", 0, False), ("c2", "c", 0, False),
        ("d1", "d", 0.05, True),
        ("d2", "d", 0.05, True),         # absorbed into the delayed d1
        ("b2", "b", 0.1, False),
        ("last", "z", 0.15, False),
    ]
    for tag, key, after, dedupe in script:
        q.enqueue(None, cb_for(tag, key), key=key, after=after,
                  dedupe=dedupe)
    threads = q.start_workers(1)
    try:
        assert done.wait(5)
        time.sleep(0.05)   # nothing more may arrive
    finally:
        q.shutdown()
        for t in threads:
            t.join(3)
    return order


def test_single_worker_order_matches_reference():
    """The same keyed enqueue script through start_workers(1) of the
    reference's queue and the port's: the same items in the same order
    (exact), dedupe absorption and the failure's retry included."""
    from tpu_dra.infra.workqueue import (
        ExponentialFailureRateLimiter as RefLimiter,
    )
    from tpu_dra.infra.workqueue import WorkQueue as RefQueue

    class RefFastRL(RefLimiter):
        def __init__(self):
            super().__init__(0.001, 0.005)

    ref = _script_order(RefQueue, RefFastRL)
    port = _script_order(WorkQueue, FastRL)
    assert port == ref
    assert [tag for tag, _ in port] == [
        "a1", "b1", "x", "flaky", "c1", "c2", "flaky", "d1", "b2", "last"]
