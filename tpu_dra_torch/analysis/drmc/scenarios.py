"""drmc scenarios: small, terminating models of the port's risky
subsystems (counterpart of tpu_dra/analysis/drmc/scenarios.py, run
against tpu_dra_torch's own parts over fake GPUs).

Two families share the scenario registry:

**Interleaving scenarios** (for explore.explore) spawn controlled tasks
against real components and assert the chaos tier's safety invariants
at every terminal state: no device double-allocation
(simcluster.chaos.chip_conflicts), allocation index == truth
(AllocationIndex.diff_against), checkpoint/CDI consistency, and an
acyclic lock-order graph (the witness runs under every schedule).
``sched-churn`` drives the MULTI-WORKER WorkQueue pool + sharded
AllocationIndex pair the parallel scheduler core (SURVEY §15) is built
on, with an explicit per-key serialization probe; ``shard-dispatch``
drives the partitioned informer's ShardDispatcher (bounded per-shard
FIFOs, overflow shedding, relist healing, mid-stream stop()) against
the same AllocationIndex truth discipline; ``batch-prepare``
drives concurrent DeviceState prepare/unprepare/health batches. ``racy-index``
is the deliberately-buggy fixture — an unserialized check-then-act on
the index — whose violating schedule the tests record and replay.

**Crash scenarios** (for crash.enumerate_crashes) run a durable-op
sequence once per enumerated crash point and assert the recovery
invariants after restart: recovery never throws, externalized successes
are durable, externalized failures stay rolled back, CDI specs never
outlive their checkpoint entries, and a faultless replay converges to
the expected final state. ``batch-prepare-crash`` is the mixed-outcome
batch (one member fails mid-apply while its siblings group-commit)
under the node flock; ``quarantine-crash`` interleaves the quarantine
ledger's journal ops with a claim lifecycle.

Scenarios must be deterministic given a schedule: no wall-clock
branching (zero-delay rate limiter), no unseeded randomness, bounded
work per task.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.infra.workqueue import RateLimiter, WorkQueue

_DRIVER = "gpu.dev"
_POOL = "drmc-node"


class _ZeroLimiter(RateLimiter):
    """No backoff: ready_at == enqueue time, so heap order is push
    order and schedules never depend on the wall clock."""

    def when(self, item_id: int) -> float:
        return 0.0


def _trace_snapshot():
    """Open-span ids at scenario build time: terminal-state checks
    assert only spans THIS scenario began were drained (SURVEY §19) —
    a sibling test's leaked span must not fail the model checker."""
    from tpu_dra_torch.infra import trace
    return trace.TRACER.open_ids()


def _open_span_violations(snapshot) -> List[str]:
    """The span-closure invariant at every terminal state — including
    crash-recovery replays: the prepare pipeline's finally must leave
    only CLOSED (possibly abandoned) spans behind, whatever the
    interleaving or crash point did."""
    from tpu_dra_torch.infra import trace
    return trace.open_span_violations(snapshot,
                                      context="at terminal state")


def _mk_claim(name: str, devices: List[str], rv: int,
              uid: Optional[str] = None) -> Dict:
    return {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "default",
                     "uid": uid or f"uid-{name}",
                     "resourceVersion": str(rv)},
        "spec": {"devices": {"requests": [{"name": "gpu"}]}},
        "status": {"allocation": {"devices": {"results": [
            {"request": "gpu", "driver": _DRIVER, "pool": _POOL,
             "device": d} for d in devices], "config": []}}},
    }


# ---------------------------------------------------------------------------
# sched-churn: WorkQueue + AllocationIndex under controlled interleaving
# ---------------------------------------------------------------------------

class SchedChurnScenario:
    """A MULTI-WORKER queue pool (two controlled consumers) processing
    keyed bind/unbind reconciles against a sharded AllocationIndex,
    while two producers enqueue (same-key dedupe included) and a
    stopper shuts the queue down mid-stream. Which pods end up bound is
    schedule-dependent BY DESIGN (an unbind racing its bind is real
    churn); the invariants are the safety properties that must hold
    under every ordering — including the pool's per-key serialization
    contract: two items sharing a key must NEVER be mid-callback on two
    workers at once (the deferral path in WorkQueue._get), witnessed by
    an explicit overlap probe rather than trusted."""

    name = "sched-churn"

    def build(self, sched) -> Dict:
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex

        queue = WorkQueue(rate_limiter=_ZeroLimiter())
        index = AllocationIndex()
        truth: Dict[str, Dict] = {}
        truth_lock = threading.Lock()   # witnessed: created under install
        rvs = itertools.count(1)
        devices = ["gpu-0", "gpu-1", "gpu-2"]
        # Per-key overlap probe: counts callbacks mid-flight per key.
        # Kept under its own witnessed lock; any count > 1 is a
        # violation of the pool's client-go parallelism contract.
        active: Dict[str, int] = {}
        overlaps: List[str] = []
        probe_lock = threading.Lock()

        def keyed(key: str, body):
            def cb(_obj) -> None:
                with probe_lock:
                    n = active.get(key, 0) + 1
                    active[key] = n
                    if n > 1:
                        overlaps.append(
                            f"key {key}: {n} callbacks mid-flight — "
                            "per-key serialization broken")
                try:
                    body()
                finally:
                    with probe_lock:
                        active[key] -= 1
            return cb

        def bind(key: str):
            def body() -> None:
                # Serialized check-then-act: the pick, the index apply
                # and the truth record commit atomically under the
                # truth lock — the discipline racy-index drops.
                with truth_lock:
                    used = {d for c in truth.values()
                            for _, _, d in _entries(c)}
                    free = sorted(set(devices) - used)
                    if not free or key in truth:
                        return
                    claim = _mk_claim(key, [free[0]], next(rvs))
                    index.apply(claim)
                    truth[key] = claim
            return keyed(key, body)

        def unbind(key: str):
            def body() -> None:
                with truth_lock:
                    claim = truth.pop(key, None)
                    if claim is not None:
                        index.remove(claim, force=True)
            return keyed(key, body)

        def producer1() -> None:
            queue.enqueue(None, bind("pod-a"), key="pod-a")
            queue.enqueue(None, bind("pod-b"), key="pod-b", dedupe=True)
            # Same-key storm: absorbs into the queued pod-b item while
            # it has not been handed to a worker; once it HAS, this
            # enqueues a second pod-b item — which the pool must then
            # defer, never run concurrently with the first.
            queue.enqueue(None, bind("pod-b"), key="pod-b", dedupe=True)

        def producer2() -> None:
            queue.enqueue(None, bind("pod-c"), key="pod-c")
            queue.enqueue(None, unbind("pod-a"), key="pod-a")

        def stopper() -> None:
            queue.shutdown()

        sched.spawn("worker0", queue.run)
        sched.spawn("worker1", queue.run)
        sched.spawn("producer1", producer1)
        sched.spawn("producer2", producer2)
        sched.spawn("stopper", stopper)
        return {"queue": queue, "index": index, "truth": truth,
                "overlaps": overlaps, "trace_snap": _trace_snapshot()}

    def check(self, ctx) -> List[str]:
        from tpu_dra_torch.simcluster.chaos import chip_conflicts

        queue, index, truth = ctx["queue"], ctx["index"], ctx["truth"]
        # Quiesce: a shutdown racing the producers legitimately strands
        # queued AND deferred items; drain both the way a restarted
        # worker would (single-threaded here, so serialization holds).
        import heapq
        while queue._heap or queue._deferred:
            while queue._heap:
                _, _, item = heapq.heappop(queue._heap)
                item.callback(item.obj)
            for key in sorted(queue._deferred):
                for item in queue._deferred.pop(key):
                    item.callback(item.obj)
        violations = list(ctx["overlaps"])
        claims = [truth[k] for k in sorted(truth)]
        violations.extend(index.diff_against(claims))
        violations.extend(chip_conflicts(claims))
        violations.extend(_open_span_violations(ctx["trace_snap"]))
        return violations

    def cleanup(self, ctx) -> None:
        ctx["queue"].shutdown()


def _entries(claim: Dict):
    from tpu_dra_torch.simcluster.scheduler import claim_entries
    return claim_entries(claim)


# ---------------------------------------------------------------------------
# shard-dispatch: the sched-churn family's sharded fan-out probe
# ---------------------------------------------------------------------------

class ShardDispatchScenario:
    """The partitioned informer's ShardDispatcher driven as explicit
    interleaved tasks: a producer offering claim deltas into BOUNDED
    per-shard FIFOs (cap 1, so overflow is reachable in most orderings),
    one drainer per shard, a relist task healing dirty shards from the
    intent record, and a stopper calling the real ``stop()`` mid-stream.
    This is the overflow-vs-relist-vs-shutdown race surface behind the
    10k-node fan-out: a shed delta MUST be healed by a shard relist, a
    relist racing fresh deltas must not resurrect stale state (seq
    gating — the scheduler's resourceVersion discipline), and a stop()
    racing live drains must strand nothing. Invariant at every terminal
    state: after the single-threaded quiesce, applied state == intended
    state per key, the AllocationIndex matches truth exactly, and no
    GPU is double-booked."""

    name = "shard-dispatch"

    def __init__(self):
        # Observability for the tests: how many offers shed in the last
        # run (check() records it) — proves the probe exercises the
        # overflow path rather than vacuously passing.
        self._last_overflows = 0

    def build(self, sched) -> Dict:
        from tpu_dra_torch.k8s.informer import ShardDispatcher
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex

        index = AllocationIndex(n_shards=2)
        truth: Dict[str, Dict] = {}
        # intent[key] = (seq, devices|None): what the apiserver said
        # last, recorded BEFORE the offer — the watch event exists even
        # when the dispatch sheds it, which is exactly why a shed must
        # mark the shard dirty.
        intent: Dict[str, Tuple[int, Optional[List[str]]]] = {}
        applied_seq: Dict[str, int] = {}
        dirty: set = set()
        truth_lock = threading.Lock()   # witnessed: created under install

        disp = ShardDispatcher(2, cap=1, name="drmc",
                               on_overflow=lambda sid, why: dirty.add(sid))
        # Two keys per shard, found deterministically (crc32 is stable).
        by_shard: Dict[int, List[str]] = {0: [], 1: []}
        i = 0
        while any(len(v) < 1 for v in by_shard.values()) or i < 4:
            k = f"pool-{i}"
            if len(by_shard[disp.route(k)]) < 2:
                by_shard[disp.route(k)].append(k)
            i += 1
        key_a, key_b = by_shard[0][0], by_shard[1][0]

        def apply_intent(key: str, seq: int,
                         devices: Optional[List[str]]) -> None:
            # Seq-gated apply: an old delta drained AFTER a relist (or a
            # relist re-reading already-applied intent) must be a no-op,
            # never a regression — the RV discipline in miniature.
            with truth_lock:
                if seq <= applied_seq.get(key, 0):
                    return
                applied_seq[key] = seq
                old = truth.pop(key, None)
                if old is not None:
                    index.remove(old, force=True)
                if devices is not None:
                    claim = _mk_claim(key, devices, seq)
                    index.apply(claim)
                    truth[key] = claim

        def delta(key: str, seq: int, devices: Optional[List[str]]):
            return lambda: apply_intent(key, seq, devices)

        def offer(key: str, seq: int,
                  devices: Optional[List[str]]) -> None:
            with truth_lock:
                intent[key] = (seq, devices)
            disp.offer(disp.route(key), delta(key, seq, devices))

        def producer() -> None:
            offer(key_a, 1, ["gpu-0"])
            offer(key_b, 2, ["gpu-1"])
            offer(key_a, 3, ["gpu-2"])   # rebind: remove + apply
            offer(key_b, 4, None)         # unbind

        def drainer(sid: int):
            def run() -> None:
                for _ in range(4):
                    disp.drain_one(sid)
            return run

        def relist() -> None:
            # Heal pass racing everything else: clear the flag FIRST so
            # a shed that lands after our truth read re-dirties the
            # shard for the terminal heal in check().
            for sid in (0, 1):
                if sid in dirty:
                    dirty.discard(sid)
                    for key in by_shard[sid]:
                        rec = intent.get(key)
                        if rec is not None:
                            apply_intent(key, rec[0], rec[1])

        def stopper() -> None:
            disp.stop()

        sched.spawn("producer", producer)
        sched.spawn("drain0", drainer(0))
        sched.spawn("drain1", drainer(1))
        sched.spawn("relist", relist)
        sched.spawn("stopper", stopper)
        return {"disp": disp, "index": index, "truth": truth,
                "intent": intent, "applied_seq": applied_seq,
                "dirty": dirty, "by_shard": by_shard}

    def check(self, ctx) -> List[str]:
        from tpu_dra_torch.simcluster.chaos import chip_conflicts

        disp, index, truth = ctx["disp"], ctx["index"], ctx["truth"]
        self._last_overflows = disp.overflows
        # Quiesce the way the informer's stop() + scheduler resync
        # would: drain stranded thunks single-threaded, then run the
        # shard relist for anything still marked dirty.
        for sid in (0, 1):
            while disp.drain_one(sid):
                pass
        for sid in sorted(ctx["dirty"]):
            for key in ctx["by_shard"][sid]:
                rec = ctx["intent"].get(key)
                if rec is not None:
                    seq, devices = rec
                    if seq > ctx["applied_seq"].get(key, 0):
                        ctx["applied_seq"][key] = seq
                        old = truth.pop(key, None)
                        if old is not None:
                            index.remove(old, force=True)
                        if devices is not None:
                            claim = _mk_claim(key, devices, seq)
                            index.apply(claim)
                            truth[key] = claim
        violations: List[str] = []
        for key, (seq, devices) in sorted(ctx["intent"].items()):
            if ctx["applied_seq"].get(key, 0) != seq:
                violations.append(
                    f"key {key}: intended seq {seq} never applied "
                    f"(got {ctx['applied_seq'].get(key, 0)}) — "
                    "shed delta not healed by relist")
            have = ([d for _, _, d in _entries(truth[key])]
                    if key in truth else None)
            if have != devices:
                violations.append(
                    f"key {key}: terminal devices {have} != intended "
                    f"{devices}")
        claims = [truth[k] for k in sorted(truth)]
        violations.extend(index.diff_against(claims))
        violations.extend(chip_conflicts(claims))
        return violations

    def cleanup(self, ctx) -> None:
        ctx["disp"].stop()


# ---------------------------------------------------------------------------
# racy-index: the deliberately-buggy fixture (violation demo + replay)
# ---------------------------------------------------------------------------

class RacyIndexScenario:
    """Check-then-act on the AllocationIndex WITHOUT serializing the
    pick against the apply: two reconciles can both observe the one
    free device between each other's index lock sections and
    double-allocate it. drmc must find a violating schedule, and the
    recorded trace must replay to the identical violation — the
    seeded-replay acceptance test."""

    name = "racy-index"

    def build(self, sched) -> Dict:
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex

        index = AllocationIndex()
        truth: Dict[str, Dict] = {}
        rvs = itertools.count(1)

        def racy_bind(key: str):
            def body() -> None:
                # BUG (on purpose): the is_taken read and the apply
                # each take the index lock, but nothing serializes the
                # pair — a sibling can interleave between them.
                if index.is_taken(_DRIVER, _POOL, "gpu-0"):
                    return
                claim = _mk_claim(key, ["gpu-0"], next(rvs))
                index.apply(claim)
                truth[key] = claim
            return body

        sched.spawn("bind-a", racy_bind("pod-a"))
        sched.spawn("bind-b", racy_bind("pod-b"))
        return {"index": index, "truth": truth}

    def check(self, ctx) -> List[str]:
        from tpu_dra_torch.simcluster.chaos import chip_conflicts
        claims = [ctx["truth"][k] for k in sorted(ctx["truth"])]
        violations = list(ctx["index"].diff_against(claims))
        violations.extend(chip_conflicts(claims))
        return violations

    def cleanup(self, ctx) -> None:
        pass


class _BoundedStore:
    """A capacity-bounded admission set: the minimal model of every
    check-then-act surface in the tree (slot claims, quota admission,
    the allocation index). ``count`` reads under the lock; ``admit``
    writes under the lock; NOTHING ties the pair together — that is
    the caller's job, and the stale-read probe exercises both ways of
    doing it."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.admitted: List[str] = []
        self._lock = threading.Lock()

    def count(self) -> int:
        with self._lock:
            return len(self.admitted)

    def admit(self, key: str) -> None:
        with self._lock:
            self.admitted.append(key)

    # drflow: REVALIDATES:admitted
    def try_admit(self, key: str) -> bool:
        """The sanctioned act: re-validates the capacity bound against
        LIVE state under the lock (the try_commit shape drflow R14's
        REVALIDATES annotation documents)."""
        with self._lock:
            if len(self.admitted) >= self.capacity:
                return False
            self.admitted.append(key)
            return True


class StaleReadProbeScenario:
    """Check-then-act on a STALE SNAPSHOT across a lock release: the
    capacity check reads under the store's lock, the lock releases at
    return, and the admit runs on the stale decision — two takers can
    both observe the free slot and overrun the bound. drmc must find
    the violating schedule; drflow R14 flags the same source shape
    statically (tests assert both directions, the R13-R15 analog of
    racy-index's seeded-replay acceptance)."""

    name = "stale-read-probe"

    def build(self, sched) -> Dict:
        store = _BoundedStore(capacity=1)

        def taker(key: str):
            def body() -> None:
                # BUG (on purpose): count() releases the lock before
                # admit() re-acquires it — nothing revalidates the
                # bound (static analog: drflow R14).
                n = store.count()
                if n < store.capacity:
                    store.admit(key)  # dralint: ignore[R14] — deliberately racy probe fixture: drmc finds the interleaving; test_flowanalysis asserts the static finding
            return body

        sched.spawn("take-a", taker("a"))
        sched.spawn("take-b", taker("b"))
        return {"store": store}

    def check(self, ctx) -> List[str]:
        store = ctx["store"]
        if len(store.admitted) > store.capacity:
            return [f"capacity {store.capacity} overrun: "
                    f"{sorted(store.admitted)} all admitted on a stale "
                    "count"]
        return []

    def cleanup(self, ctx) -> None:
        pass


class StaleReadFixedScenario:
    """The SANCTIONED counterpart: the act routes through try_admit,
    which re-validates the bound under the lock (the REVALIDATES
    protocol). No schedule may overrun — this one IS a gate scenario,
    so the protocol the static annotation documents stays dynamically
    proven."""

    name = "stale-read-fixed"

    def build(self, sched) -> Dict:
        store = _BoundedStore(capacity=1)

        def taker(key: str):
            def body() -> None:
                if store.count() < store.capacity:
                    store.try_admit(key)
            return body

        sched.spawn("take-a", taker("a"))
        sched.spawn("take-b", taker("b"))
        return {"store": store}

    def check(self, ctx) -> List[str]:
        store = ctx["store"]
        if len(store.admitted) > store.capacity:
            return [f"capacity {store.capacity} overrun through "
                    "try_admit: the revalidating commit is broken"]
        return []

    def cleanup(self, ctx) -> None:
        pass


# ---------------------------------------------------------------------------
# evict-churn: eviction racing the optimistic bind pipeline (SURVEY §18)
# ---------------------------------------------------------------------------

class EvictChurnScenario:
    """Evict-vs-prepare and evict-vs-commit: binders place claims
    through the REAL optimistic pipeline (snapshot -> pick ->
    try_commit reservation -> truth write -> apply -> release) while an
    evictor kills a device mid-stream and releases its holder the way
    the scheduler's evict scan does (truth removal mirrored by
    remove(force=True)), then re-drives the victim through the queue.
    Which claims end up bound is schedule-dependent BY DESIGN; the
    safety properties under EVERY ordering:

    - no device double-allocation (a reservation the evictor interleaves
      with must still be all-or-nothing);
    - index == truth at quiesce;
    - no claim bound to the dead device once the eviction has run —
      a bind racing the eviction must abort via the dead-set check and
      release its reservation, never commit onto dead hardware."""

    name = "evict-churn"

    def build(self, sched) -> Dict:
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex

        queue = WorkQueue(rate_limiter=_ZeroLimiter())
        index = AllocationIndex()
        truth: Dict[str, Dict] = {}
        dead: set = set()
        evicted: List[str] = []
        truth_lock = threading.Lock()   # witnessed: created under install
        rvs = itertools.count(1)
        devices = ["gpu-0", "gpu-1", "gpu-2"]

        def bind(key: str):
            def body(_obj=None) -> None:
                for _attempt in range(4):
                    view = index.snapshot(_POOL)
                    with truth_lock:
                        if key in truth:
                            return
                        free = [d for d in devices
                                if d not in dead
                                and not view.is_taken(_DRIVER, d)]
                    if not free:
                        return
                    entries = ((_DRIVER, _POOL, free[0]),)
                    if not index.try_commit(_POOL, [(key, entries)]):
                        continue  # conflict: re-scan a fresh snapshot
                    claim = _mk_claim(key, [free[0]], next(rvs))
                    with truth_lock:
                        if free[0] in dead:
                            # The device died between the reservation
                            # and the write: abort — committing would
                            # bind onto dead hardware.
                            index.release(_POOL, [key])
                            return
                        # Truth write + index apply commit atomically
                        # (the apiserver-serialized mutation-cache
                        # discipline, same as sched-churn): the evictor
                        # must never observe a truth entry whose index
                        # apply has not landed, or its higher-rv
                        # dealloc has no routing home to supersede.
                        truth[key] = claim
                        index.apply(claim)
                    index.release(_POOL, [key])
                    return
            return body

        def evictor() -> None:
            # gpu-0 dies: release every holder through the real
            # pipeline — a DEALLOCATED claim write at a HIGHER rv,
            # mirrored into the index via apply (exactly what
            # _after_claim_write does) — then re-drive the victims.
            # NOT remove(force=True): that only advances the watermark
            # to the victim's OWN rv, so a binder's delayed same-rv
            # apply would pass the strict staleness check and
            # resurrect the evicted entry (the real scheduler never
            # has this problem because eviction IS a new higher-RV
            # write; the miniature must model the same thing).
            victims = []
            with truth_lock:
                dead.add("gpu-0")
                for k in sorted(truth):
                    if any(d == "gpu-0"
                           for _dr, _p, d in _entries(truth[k])):
                        claim = truth.pop(k)
                        index.apply(_mk_claim(
                            k, [], next(rvs),
                            uid=claim["metadata"]["uid"]))
                        victims.append(k)
                        evicted.append(k)
            for k in victims:
                queue.enqueue(None, bind(k), key=k, dedupe=True)

        def producer1() -> None:
            queue.enqueue(None, bind("pod-a"), key="pod-a")
            queue.enqueue(None, bind("pod-b"), key="pod-b", dedupe=True)

        def producer2() -> None:
            queue.enqueue(None, bind("pod-c"), key="pod-c")

        def stopper() -> None:
            queue.shutdown()

        sched.spawn("worker0", queue.run)
        sched.spawn("worker1", queue.run)
        sched.spawn("producer1", producer1)
        sched.spawn("producer2", producer2)
        sched.spawn("evictor", evictor)
        sched.spawn("stopper", stopper)
        return {"queue": queue, "index": index, "truth": truth,
                "dead": dead, "evicted": evicted,
                "trace_snap": _trace_snapshot()}

    def check(self, ctx) -> List[str]:
        import heapq

        from tpu_dra_torch.simcluster.chaos import chip_conflicts

        queue, index, truth = ctx["queue"], ctx["index"], ctx["truth"]
        # Quiesce drain, as in sched-churn: a shutdown racing the
        # producers/evictor legitimately strands queued re-binds.
        while queue._heap or queue._deferred:
            while queue._heap:
                _, _, item = heapq.heappop(queue._heap)
                item.callback(item.obj)
            for key in sorted(queue._deferred):
                for item in queue._deferred.pop(key):
                    item.callback(item.obj)
        violations: List[str] = []
        claims = [truth[k] for k in sorted(truth)]
        violations.extend(index.diff_against(claims))
        violations.extend(chip_conflicts(claims))
        dead = ctx["dead"]
        if dead:  # the evictor ran: nobody may hold the dead device
            for key in sorted(truth):
                on_dead = [d for _dr, _p, d in _entries(truth[key])
                           if d in dead]
                if on_dead:
                    violations.append(
                        f"claim {key} bound to dead device(s) "
                        f"{on_dead} after eviction")
        violations.extend(_open_span_violations(ctx["trace_snap"]))
        return violations

    def cleanup(self, ctx) -> None:
        ctx["queue"].shutdown()


# ---------------------------------------------------------------------------
# takeover-resync: deposed-leader commits vs. HA takeover (SURVEY §22)
# ---------------------------------------------------------------------------

class TakeoverScenario:
    """Deposed-leader-commit vs. takeover-resync, against the REAL
    fencing reactor on a real FakeCluster: an old scheduler incarnation
    (generation 1, device picks baked from a pre-takeover snapshot —
    the stale standby view) commits claim allocations while the new
    incarnation bumps the lease (leaseTransitions 1 -> 2), re-lists
    cluster truth (_full_resync's rebuild), and re-drives whatever is
    still unallocated under generation 2. The explorer owns the
    interleaving of every cluster op; under ALL of them:

    - never two acting leaders' commits both land for one claim (a
      deposed write arriving after the bump is refused by the fencing
      reactor; one landing anyway would also surface as the old
      leader's stale device pick double-allocating a GPU the new
      leader handed out);
    - no device double-allocation across the takeover;
    - the new leader is never fenced (its stamp IS the current
      generation) and leaks no claim: every claim is allocated at
      quiesce, by exactly one incarnation;
    - the rebuilt index matches cluster truth."""

    name = "takeover-resync"

    def build(self, sched) -> Dict:
        from tpu_dra_torch.infra.leaderelect import (
            FENCING_ANNOTATION, LEASE_NAME, LEASE_NAMESPACE,
            install_fencing,
        )
        from tpu_dra_torch.k8s import LEASES, RESOURCECLAIMS
        from tpu_dra_torch.k8s.client import ConflictError
        from tpu_dra_torch.k8s.fake import FakeCluster, new_lease
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex

        cluster = FakeCluster()  # witnessed: locks created under install
        install_fencing(cluster)
        # Fixed clock: the reactor reads only leaseTransitions, so a
        # frozen renewTime keeps the scenario schedule-deterministic.
        cluster.create(LEASES, new_lease(
            LEASE_NAME, LEASE_NAMESPACE, "old", 1.0, 0.0))
        for key in ("pod-a", "pod-b"):
            cluster.create(RESOURCECLAIMS, {
                "apiVersion": "resource.k8s.io/v1",
                "kind": "ResourceClaim",
                "metadata": {"name": key, "namespace": "default"},
                "spec": {"devices": {"requests": [{"name": "gpu"}]}},
            })
        index = AllocationIndex()
        log: Dict[str, List[str]] = {
            "old_landed": [], "old_refused": [],
            "new_landed": [], "new_refused": []}
        devices = ["gpu-0", "gpu-1"]

        def commit(key: str, device: str, gen: int,
                   landed: List[str], refused: List[str]) -> None:
            obj = cluster.get(RESOURCECLAIMS, key, "default")
            obj["metadata"].setdefault("annotations", {})[
                FENCING_ANNOTATION] = str(gen)
            obj["status"] = {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": _DRIVER, "pool": _POOL,
                 "device": device}], "config": []}}}
            try:
                updated = cluster.update(RESOURCECLAIMS, obj, "default")
            except ConflictError:
                refused.append(key)
                return
            landed.append(key)
            if gen == 2:  # only the new incarnation maintains the index
                index.apply(updated)

        def old_leader() -> None:
            # Device picks frozen from the pre-takeover free set: the
            # deposed leader acting on a world that moved without it.
            commit("pod-a", devices[0], 1,
                   log["old_landed"], log["old_refused"])
            commit("pod-b", devices[1], 1,
                   log["old_landed"], log["old_refused"])

        def takeover() -> None:
            # Bump-then-resync, the elector's _takeover + promote() in
            # miniature: after the CAS lands, every pre-bump commit is
            # visible to the re-list and every post-bump deposed write
            # is refused, so the rebuilt view is linearized.
            lease = cluster.get(LEASES, LEASE_NAME, LEASE_NAMESPACE)
            lease["spec"]["holderIdentity"] = "new"
            lease["spec"]["leaseTransitions"] = 2
            cluster.update(LEASES, lease, LEASE_NAMESPACE)
            claims = cluster.list(RESOURCECLAIMS, namespace="default")
            taken, pending = set(), []
            for c in claims:
                entries = [r.get("device") for r in
                           ((c.get("status") or {}).get("allocation")
                            or {}).get("devices", {}).get("results", [])]
                if entries:
                    taken.update(entries)
                    index.apply(c)
                else:
                    pending.append(c["metadata"]["name"])
            free = [d for d in devices if d not in taken]
            # Reversed re-drive order: if a deposed write lands where
            # it must not, its stale pick collides with a GPU handed
            # out here instead of silently shadowing the same one.
            for key in sorted(pending, reverse=True):
                commit(key, free.pop(0), 2,
                       log["new_landed"], log["new_refused"])

        sched.spawn("old-leader", old_leader)
        sched.spawn("takeover", takeover)
        return {"cluster": cluster, "index": index, "log": log,
                "trace_snap": _trace_snapshot()}

    def check(self, ctx) -> List[str]:
        from tpu_dra_torch.k8s import RESOURCECLAIMS
        from tpu_dra_torch.simcluster.chaos import chip_conflicts

        cluster, index, log = ctx["cluster"], ctx["index"], ctx["log"]
        violations: List[str] = []
        claims = cluster.list(RESOURCECLAIMS, namespace="default")
        violations.extend(chip_conflicts(claims))
        violations.extend(index.diff_against(claims))
        for c in claims:
            name = c["metadata"]["name"]
            results = ((c.get("status") or {}).get("allocation")
                       or {}).get("devices", {}).get("results", [])
            if not results:
                violations.append(
                    f"claim {name} leaked across takeover "
                    f"(unallocated at quiesce)")
        both = set(log["old_landed"]) & set(log["new_landed"])
        if both:
            violations.append(
                f"two acting leaders' commits both landed for "
                f"{sorted(both)}")
        if log["new_refused"]:
            violations.append(
                f"acting leader fenced on its own generation: "
                f"{log['new_refused']}")
        violations.extend(_open_span_violations(ctx["trace_snap"]))
        return violations

    def cleanup(self, ctx) -> None:
        pass


# ---------------------------------------------------------------------------
# batch-prepare: concurrent DeviceState batches under controlled scheduling
# ---------------------------------------------------------------------------

class BatchPrepareScenario:
    """Two prepare batches and a health-event storm interleaved against
    one DeviceState: the global state lock, the per-GPU locks and the
    group-commit checkpoint pipeline under every explored ordering.
    Terminal invariants are the chaos harness's: checkpoint == expected
    completed set, CDI specs == checkpoint, idempotent re-prepare, and
    the health marks fully reversed."""

    name = "batch-prepare"

    def build(self, sched) -> Dict:
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState

        tmp = tempfile.mkdtemp(prefix="drmc-bp-")
        backend = FakeBackend(default_fake_gpus(4))
        cdi = CDIHandler(os.path.join(tmp, "cdi"),
                         driver_root=os.path.join(tmp, "drv"))
        # async_cdi off: the writer-pool thread is not a controlled
        # task, so its scheduling would leak uncontrolled concurrency
        # into the explored interleavings.
        state = DeviceState(
            backend=backend, cdi=cdi,
            checkpoints=CheckpointManager(os.path.join(tmp, "plugin")),
            driver_name=_DRIVER, node_name=_POOL, async_cdi=False)

        claims = {n: _mk_claim(n, [f"gpu-{i}"], rv=1)
                  for i, n in enumerate(("ca", "cb", "cc"))}
        results: Dict[str, Dict] = {}

        def batch1() -> None:
            res = state.prepare_batch([claims["ca"], claims["cb"]])
            results.update({uid: r.error for uid, r in res.items()})
            errs = state.unprepare_batch([claims["ca"]["metadata"]["uid"]])
            results["unprep-ca"] = errs[claims["ca"]["metadata"]["uid"]]

        def batch2() -> None:
            res = state.prepare_batch([claims["cc"]])
            results.update({uid: r.error for uid, r in res.items()})

        def health() -> None:
            state.mark_unhealthy(3)
            state.healthy_devices()
            state.mark_healthy(3)

        sched.spawn("batch1", batch1)
        sched.spawn("batch2", batch2)
        sched.spawn("health", health)
        return {"tmp": tmp, "state": state, "cdi": cdi,
                "claims": claims, "results": results,
                "trace_snap": _trace_snapshot()}

    def check(self, ctx) -> List[str]:
        from tpu_dra_torch.gpuplugin.checkpoint import PREPARE_COMPLETED

        state, claims = ctx["state"], ctx["claims"]
        v: List[str] = []
        for key, err in sorted(ctx["results"].items()):
            if err:
                v.append(f"operation {key} failed: {err}")
        want = {claims["cb"]["metadata"]["uid"],
                claims["cc"]["metadata"]["uid"]}
        snap = state.checkpoint_snapshot()
        if set(snap.claims) != want:
            v.append(f"checkpoint {sorted(snap.claims)} != "
                     f"expected {sorted(want)}")
        for uid, pc in snap.claims.items():
            if pc.state != PREPARE_COMPLETED:
                v.append(f"claim {uid} left {pc.state}")
        specs = set(ctx["cdi"].list_claim_uids())
        if specs != want:
            v.append(f"CDI specs {sorted(specs)} != expected "
                     f"{sorted(want)}")
        # Idempotent re-prepare (uncontrolled: the run is over).
        res = state.prepare_batch([claims["cb"]])
        err = res[claims["cb"]["metadata"]["uid"]].error
        if err:
            v.append(f"idempotent re-prepare failed: {err}")
        if len(state.healthy_devices()) != len(state.allocatable):
            v.append("health marks not fully reversed")
        v.extend(_open_span_violations(ctx["trace_snap"]))
        return v

    def cleanup(self, ctx) -> None:
        try:
            ctx["state"].close()
        finally:
            shutil.rmtree(ctx["tmp"], ignore_errors=True)


# ---------------------------------------------------------------------------
# batch-prepare-crash: the crash-point scenario (crash.enumerate_crashes)
# ---------------------------------------------------------------------------

class BatchPrepareCrashScenario:
    """A mixed-outcome prepare batch (member `cb` fails mid-apply via
    the prepare.batch_apply fault site; its siblings group-commit) and
    a follow-up unprepare, both under the node flock — then a crash at
    every durable op. Recovery invariants: recovery never
    throws, externalized successes are durable, the externalized loser
    stays rolled back, CDI specs never outlive checkpoint entries, and
    the kubelet-style faultless replay converges."""

    name = "batch-prepare-crash"

    def setup(self) -> Dict:
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState

        tmp = tempfile.mkdtemp(prefix="drmc-crash-")
        backend = FakeBackend(default_fake_gpus(4))
        cdi = CDIHandler(os.path.join(tmp, "cdi"),
                         driver_root=os.path.join(tmp, "drv"))
        # async_cdi is bypassed anyway while the recorder is installed
        # (determinism of the durable-op sequence); journal_compact_lag
        # is forced low so the body CROSSES the compaction threshold —
        # the compaction's slot store + segment retirement (fresh
        # segment create, old-chain unlinks, dir sync) get
        # crash-enumerated too — and segment_roll_bytes is forced tiny
        # so appends between compactions ALSO cross the size-roll
        # rotation (settle-old-tail fdatasync, new-segment
        # create, deferred dir sync).
        state = DeviceState(
            backend=backend, cdi=cdi,
            checkpoints=CheckpointManager(os.path.join(tmp, "plugin"),
                                          journal_compact_lag=2,
                                          segment_roll_bytes=64),
            driver_name=_DRIVER, node_name=_POOL, async_cdi=False)
        claims = {n: _mk_claim(n, [f"gpu-{i}"], rv=1)
                  for i, n in enumerate(("ca", "cb", "cc"))}
        return {"tmp": tmp, "state": state, "cdi": cdi,
                "claims": claims, "externalized": {},
                "trace_snap": _trace_snapshot()}

    def body(self, ctx) -> None:
        from tpu_dra_torch.infra.faults import FAULTS, Always
        from tpu_dra_torch.infra.flock import Flock

        state, claims = ctx["state"], ctx["claims"]
        ext: Dict[str, str] = ctx["externalized"]
        loser = claims["cb"]["metadata"]["uid"]

        def fail_loser(claim_uid=None, **_ctx) -> None:
            if claim_uid == loser:
                raise RuntimeError("drmc injected mid-apply failure")

        lock = Flock(os.path.join(ctx["tmp"], "prep.lock"))
        with lock:
            with FAULTS.armed("prepare.batch_apply", Always(),
                              action=fail_loser):
                res = state.prepare_batch(
                    [claims["ca"], claims["cb"], claims["cc"]])
        # The RPC returned: these outcomes are now externalized — from
        # here on, a crash may not un-happen them.
        for uid, r in res.items():
            ext[uid] = "failed" if r.error else "completed"
        # Once the unprepare is REQUESTED the claim is transitioning by
        # kubelet's own intent: a crash may legitimately land on either
        # side of its removal, so the survival invariant relaxes to
        # "completed or cleanly gone" until the result externalizes.
        uid_ca = claims["ca"]["metadata"]["uid"]
        ext[uid_ca] = "unprepare-requested"
        with lock:
            errs = state.unprepare_batch([uid_ca])
        if errs[uid_ca] is None:
            ext[uid_ca] = "unprepared"

    def dispose(self, ctx) -> None:
        """The simulated process death: release fds, store nothing."""
        ctx["state"].close()

    def recover_and_check(self, ctx) -> List[str]:
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
        from tpu_dra_torch.gpuplugin.checkpoint import (
            PREPARE_COMPLETED, CheckpointManager,
        )
        from tpu_dra_torch.gpuplugin.device_state import DeviceState

        tmp, claims = ctx["tmp"], ctx["claims"]
        ext: Dict[str, str] = ctx["externalized"]
        v: List[str] = []
        state2 = None
        try:
            backend = FakeBackend(default_fake_gpus(4))
            cdi2 = CDIHandler(os.path.join(tmp, "cdi"),
                              driver_root=os.path.join(tmp, "drv"))
            try:
                state2 = DeviceState(
                    backend=backend, cdi=cdi2,
                    checkpoints=CheckpointManager(
                        os.path.join(tmp, "plugin")),
                    driver_name=_DRIVER, node_name=_POOL,
                    async_cdi=False)
            except Exception as e:  # noqa: BLE001 — THE invariant:
                # recovery must never be unable to come up.
                return [f"recovery failed to start: {e}"]
            snap = state2.checkpoint_snapshot()
            for uid, status in sorted(ext.items()):
                pc = snap.claims.get(uid)
                if status == "completed" and (
                        pc is None or pc.state != PREPARE_COMPLETED):
                    v.append(f"externalized success for {uid} lost "
                             "(success before the terminal sync?)")
                elif status == "failed" and pc is not None \
                        and pc.state == PREPARE_COMPLETED:
                    v.append(f"externalized failure for {uid} "
                             "resurrected as completed")
                elif status == "unprepared" and pc is not None:
                    v.append(f"externalized unprepare of {uid} "
                             "resurrected")
                elif status == "unprepare-requested" and pc is not None \
                        and pc.state != PREPARE_COMPLETED:
                    v.append(f"in-flight unprepare left {uid} in "
                             f"{pc.state} (neither committed nor gone)")
            orphans = set(cdi2.list_claim_uids()) - set(snap.claims)
            if orphans:
                v.append(f"CDI specs outlive checkpoint: {sorted(orphans)}")

            # Kubelet-style faultless replay: re-issue both RPCs; the
            # pipeline must be idempotent from ANY crash image and
            # converge to the canonical final state.
            res = state2.prepare_batch(
                [claims["ca"], claims["cb"], claims["cc"]])
            for uid, r in sorted(res.items()):
                if r.error:
                    v.append(f"replay prepare of {uid} failed: {r.error}")
            errs = state2.unprepare_batch(
                [claims["ca"]["metadata"]["uid"]])
            err = errs[claims["ca"]["metadata"]["uid"]]
            if err is not None:
                v.append(f"replay unprepare failed: {err}")
            final = state2.checkpoint_snapshot()
            want = {claims["cb"]["metadata"]["uid"],
                    claims["cc"]["metadata"]["uid"]}
            if set(final.claims) != want:
                v.append(f"replay converged to {sorted(final.claims)}, "
                         f"expected {sorted(want)}")
            for uid, pc in final.claims.items():
                if pc.state != PREPARE_COMPLETED:
                    v.append(f"replay left {uid} {pc.state}")
            specs = set(cdi2.list_claim_uids())
            if specs != want:
                v.append(f"replay CDI specs {sorted(specs)} != "
                         f"{sorted(want)}")
            # Span closure INCLUDING crash-recovery replays: the crash
            # unwound prepare_batch through its finally (spans
            # abandoned, never leaked), and the replay closed its own.
            v.extend(_open_span_violations(ctx["trace_snap"]))
            return v
        finally:
            if state2 is not None:
                state2.close()
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# quarantine-crash: the quarantine ledger's journal ops crash-enumerated
# ---------------------------------------------------------------------------

class QuarantineCrashScenario:
    """The quarantine ladder's durable ops (SURVEY §18) under the crash
    enumerator, INTERLEAVED with a real claim lifecycle so quarantine
    snapshots and claim upsert/remove deltas coexist in one journal:
    a claim prepares, two GPUs flap to graduation (journal append +
    group sync each), an operator clear follows, the claim unprepares —
    then a crash after EVERY durable op in every variant. Recovery
    invariants: the rebuilt DeviceState always comes up; an
    externalized transition (the call RETURNED) is durable — quarantine
    AND claim alike; a crash can never half-quarantine; and the
    faultless replay converges to the canonical final state from ANY
    crash image."""

    name = "quarantine-crash"

    def setup(self) -> Dict:
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState

        tmp = tempfile.mkdtemp(prefix="drmc-quar-")
        backend = FakeBackend(default_fake_gpus(4))
        cdi = CDIHandler(os.path.join(tmp, "cdi"),
                         driver_root=os.path.join(tmp, "drv"))
        state = DeviceState(
            backend=backend, cdi=cdi,
            checkpoints=CheckpointManager(os.path.join(tmp, "plugin")),
            driver_name=_DRIVER, node_name=_POOL, async_cdi=False,
            quarantine_threshold=2, quarantine_window_s=3600.0)
        uuids = {c.index: c.uuid for c in backend.gpus()}
        return {"tmp": tmp, "state": state, "uuids": uuids,
                "claims": {"qa": _mk_claim("qa", ["gpu-2"], rv=1)},
                "externalized": {}, "trace_snap": _trace_snapshot()}

    @staticmethod
    def _ladder(state, gpu: int) -> None:
        """Two flaps: transition in, recover, transition in — crosses
        threshold=2 and graduates on the second mark_unhealthy."""
        state.mark_unhealthy(gpu)
        state.mark_healthy(gpu)
        state.mark_unhealthy(gpu)

    def body(self, ctx) -> None:
        state, uuids = ctx["state"], ctx["uuids"]
        ext: Dict[str, str] = ctx["externalized"]
        uid_qa = ctx["claims"]["qa"]["metadata"]["uid"]
        res = state.prepare_batch([ctx["claims"]["qa"]])
        ext["claim"] = "failed" if res[uid_qa].error else "completed"
        self._ladder(state, 0)
        if uuids[0] in state.quarantined_gpus():
            ext[uuids[0]] = "quarantined"
        self._ladder(state, 1)
        if uuids[1] in state.quarantined_gpus():
            ext[uuids[1]] = "quarantined"
        # Once the operator clear is REQUESTED the record is going away
        # by intent: a crash may land on either side of its removal, so
        # the survival invariant relaxes until the call returns (the
        # same relaxation as batch-prepare-crash's unprepare-requested).
        ext[uuids[0]] = "clear-requested"
        state.clear_quarantine(0)
        ext[uuids[0]] = "cleared"
        ext["claim"] = "unprepare-requested"
        errs = state.unprepare_batch([uid_qa])
        if errs[uid_qa] is None:
            ext["claim"] = "unprepared"

    def dispose(self, ctx) -> None:
        ctx["state"].close()

    def recover_and_check(self, ctx) -> List[str]:
        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState

        tmp, uuids = ctx["tmp"], ctx["uuids"]
        ext: Dict[str, str] = ctx["externalized"]
        v: List[str] = []
        state2 = None
        try:
            backend = FakeBackend(default_fake_gpus(4))
            try:
                state2 = DeviceState(
                    backend=backend,
                    cdi=CDIHandler(os.path.join(tmp, "cdi"),
                                   driver_root=os.path.join(tmp, "drv")),
                    checkpoints=CheckpointManager(
                        os.path.join(tmp, "plugin")),
                    driver_name=_DRIVER, node_name=_POOL,
                    async_cdi=False,
                    quarantine_threshold=2, quarantine_window_s=3600.0)
            except Exception as e:  # noqa: BLE001 — THE invariant
                return [f"recovery failed to start: {e}"]
            from tpu_dra_torch.gpuplugin.checkpoint import PREPARE_COMPLETED

            uid_qa = ctx["claims"]["qa"]["metadata"]["uid"]
            q = set(state2.quarantined_gpus())
            for uuid, status in sorted(ext.items()):
                if status == "quarantined" and uuid not in q:
                    v.append(f"externalized quarantine of {uuid} lost")
                elif status == "cleared" and uuid in q:
                    v.append(f"externalized clear of {uuid} "
                             "resurrected as quarantined")
                # "clear-requested": mid-clear crash — quarantined or
                # cleared are BOTH legal images; replay converges below.
            pc = state2.checkpoint_snapshot().claims.get(uid_qa)
            claim_ext = ext.get("claim")
            if claim_ext == "completed" and (
                    pc is None or pc.state != PREPARE_COMPLETED):
                v.append("externalized prepare lost alongside the "
                         "quarantine journal ops")
            elif claim_ext == "unprepared" and pc is not None:
                v.append("externalized unprepare resurrected")
            elif claim_ext == "unprepare-requested" and pc is not None \
                    and pc.state != PREPARE_COMPLETED:
                v.append(f"in-flight unprepare left {uid_qa} {pc.state}")
            # Half-quarantine is impossible by construction: a GPU is
            # quarantined iff its ledger record exists; verify the
            # ledger and the publish exclusion agree.
            names = {d["name"] for d in state2.healthy_devices()}
            for uuid in q:
                leaked = [n for n in names
                          if state2.allocatable[n].gpu.uuid == uuid]
                if leaked:
                    v.append(f"quarantined GPU {uuid} still "
                             f"published: {leaked}")

            # Faultless replay: the same lifecycle from ANY crash image
            # must converge to {GPU 1 quarantined, GPU 0 clear, no
            # claims}.
            res = state2.prepare_batch([ctx["claims"]["qa"]])
            if res[uid_qa].error:
                v.append(f"replay prepare failed: {res[uid_qa].error}")
            self._ladder(state2, 0)
            self._ladder(state2, 1)
            state2.clear_quarantine(0)
            errs = state2.unprepare_batch([uid_qa])
            if errs[uid_qa] is not None:
                v.append(f"replay unprepare failed: {errs[uid_qa]}")
            final = set(state2.quarantined_gpus())
            if final != {uuids[1]}:
                v.append(f"replay converged to {sorted(final)}, "
                         f"expected {{{uuids[1]}}}")
            if state2.checkpoint_snapshot().claims:
                v.append("replay left checkpoint claims behind")
            names = {d["name"] for d in state2.healthy_devices()}
            if any(state2.allocatable[n].gpu.uuid == uuids[1]
                   for n in names):
                v.append("replayed quarantine of GPU 1 still published")
            v.extend(_open_span_violations(ctx["trace_snap"]))
            return v
        finally:
            if state2 is not None:
                state2.close()
            shutil.rmtree(tmp, ignore_errors=True)


INTERLEAVING_SCENARIOS = {
    SchedChurnScenario.name: SchedChurnScenario,
    ShardDispatchScenario.name: ShardDispatchScenario,
    BatchPrepareScenario.name: BatchPrepareScenario,
    EvictChurnScenario.name: EvictChurnScenario,
    TakeoverScenario.name: TakeoverScenario,
    RacyIndexScenario.name: RacyIndexScenario,
    StaleReadProbeScenario.name: StaleReadProbeScenario,
    StaleReadFixedScenario.name: StaleReadFixedScenario,
}

# Scenarios the CI gate runs (racy-index and stale-read-probe are the
# negative fixtures: they are SUPPOSED to violate, so they live in
# tests, not the gate; stale-read-fixed keeps the REVALIDATES protocol
# dynamically proven).
GATE_SCENARIOS = (SchedChurnScenario.name, ShardDispatchScenario.name,
                  BatchPrepareScenario.name,
                  EvictChurnScenario.name, StaleReadFixedScenario.name,
                  TakeoverScenario.name)

CRASH_SCENARIOS = {
    BatchPrepareCrashScenario.name: BatchPrepareCrashScenario,
    QuarantineCrashScenario.name: QuarantineCrashScenario,
}
