"""DRA scheduler sim: claims-from-templates, device allocation, binding
(counterpart of tpu_dra/simcluster/scheduler.py).

Stands in for the upstream kube-scheduler's DRA plugin and the
kube-controller-manager's resourceclaim controller (neither is driver
code). Allocation follows the real algorithm's observable behavior:
DeviceClass CEL selectors are matched against device attributes
published in ResourceSlices, devices already referenced by any allocated
claim are excluded (a whole GPU and its MIG devices exclude each other,
two MIG devices of one GPU may coexist), and the pod binds to a node
that can satisfy every claim.

Two drive modes:

- **event mode** (``start()``): informers watch Pods / ResourceClaims /
  ResourceSlices / DeviceClasses / Nodes, only dirty pods are enqueued,
  and the allocated-device set lives in an incremental, sharded
  ``AllocationIndex`` maintained from claim watch events plus the
  scheduler's own writes (mutation-cache style). Claim GC runs from
  pod-delete events with a low-frequency sweep as the safety net; the
  index falls back to a guarded resync of its dirty shards only when an
  event is known-dropped or an index apply fails (fault sites
  ``sched.watch_event`` / ``sched.index_apply`` / ``sched.shard_apply``).
  The informers hand out zero-copy views (read-only by contract; the
  chaos walks check it with ``informer.SHADOW``), and the claims
  informer is partitioned by allocation pool with the index's crc32
  shard function, so informer shard i feeds index shard i; a shed delta
  (``sched.watch_shard_dispatch``) dirties exactly that index shard.
  A pool of ``workers`` threads drains the queue (default
  ``TPU_DRA_SCHED_WORKERS`` or 4; the queue's per-key serialization keeps
  items of one pod, one GC key or the resync exclusive), and allocation
  commits optimistically (``try_commit``) against an immutable per-pool
  snapshot, so a stale pick surfaces as a re-scan, never a double
  allocation.
- **sync mode** (``reconcile_once()`` on an unstarted scheduler): the
  poll-and-scan path for unit tests: full-lists Pods and ResourceClaims
  and rebuilds a transient index per pass.

CEL selector evaluation is compile-cached (simcluster.cel). With the
TopologyAwareScheduling gate on, a multi-GPU request on a node that
publishes coordinates takes the topology-scored pick
(``topology.placement.best_placement``).

HA mode: ``start(standby=True)``, ``set_lease_generation`` and
``promote()`` are driven by ``infra.leaderelect.LeaderElector``'s
callbacks, and every claim-status write carries the leader's fencing
generation (``FENCING_ANNOTATION``), which ``install_fencing`` checks.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import time
import zlib
from collections import deque
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS, FaultInjected
from tpu_dra_torch.infra.leaderelect import FENCING_ANNOTATION
from tpu_dra_torch.infra.metrics import (
    SCHED_CLAIMS_GCED, SCHED_EVICTIONS, SCHED_FULL_RELISTS,
    SCHED_PODS_BOUND, SCHED_SHARD_RESYNCS, SCHED_SNAPSHOT_CONFLICTS,
    SCHED_WATCH_EVENTS, SCHED_WORKERS, TOPO_ALLOCS, TOPO_FREE_CUBOID,
    TOPO_SCORE_SECONDS, Timer,
)
from tpu_dra_torch.infra.trace import TRACEPARENT_ANNOTATION, TRACER
from tpu_dra_torch.infra.workqueue import (
    ExponentialFailureRateLimiter, WorkQueue,
)
from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ConflictError, NotFoundError,
    json_deepcopy,
)
from tpu_dra_torch.k8s.informer import Informer
from tpu_dra_torch.k8s.resources import (
    DEVICECLASSES, NODES, PODS, RESOURCECLAIMS, RESOURCECLAIMTEMPLATES,
    RESOURCESLICES,
)
from tpu_dra_torch.simcluster import cel
from tpu_dra_torch.topology import placement

log = logging.getLogger("simcluster.scheduler")

# sys.setswitchinterval is interpreter-global: the raise is refcounted so
# overlapping Scheduler lifecycles in one process can neither revert the
# interval under a still-running sibling nor leak the raised value past
# the last stop() (see Scheduler.start for the why).
_switch_lock = threading.Lock()
_switch_refs = 0
_switch_saved = 0.0


def _raise_switch_interval() -> None:
    global _switch_refs, _switch_saved
    with _switch_lock:
        _switch_refs += 1
        if _switch_refs == 1:
            _switch_saved = sys.getswitchinterval()
            sys.setswitchinterval(max(
                _switch_saved,
                float(os.environ.get(
                    "TPU_DRA_SCHED_SWITCH_INTERVAL", "0.02"))))


def _restore_switch_interval() -> None:
    global _switch_refs
    with _switch_lock:
        _switch_refs -= 1
        if _switch_refs == 0:
            sys.setswitchinterval(_switch_saved)


# A MIG device's name is its GPU's plus this infix and the placement
# (gpu-3-mig-3g40gb-4 on gpu-3).
MIG_INFIX = "-mig-"

_Entry = Tuple[str, str, str]  # (driver, pool, device)


def _parent_of(device: str) -> str:
    """MIG devices ('gpu-N-mig-...') partition their GPU ('gpu-N');
    everything else is its own parent."""
    return device.split(MIG_INFIX)[0] if MIG_INFIX in device else device


def _whole_marker(name: str) -> str:
    return f"{name}{MIG_INFIX}*"


def _expand(entries: Iterable[_Entry]) -> List[_Entry]:
    """Allocation entries plus their partition-semantics block markers
    (the DRA partitionable-device counter analog): a whole-GPU
    allocation blocks its MIG devices (marker '<gpu>-mig-*') and a MIG
    device blocks the whole GPU (marker = parent name), while two MIG
    devices of one GPU can coexist."""
    out: List[_Entry] = []
    for driver, pool, name in entries:
        out.append((driver, pool, name))
        parent = _parent_of(name)
        out.append((driver, pool, parent) if parent != name
                   else (driver, pool, _whole_marker(name)))
    return out


def claim_key(obj: Dict) -> str:
    meta = obj.get("metadata", {})
    return f"{meta.get('namespace', 'default')}/{meta['name']}"


def claim_entries(claim: Dict) -> Tuple[_Entry, ...]:
    """The (driver, pool, device) results of a claim's allocation
    (empty when unallocated)."""
    alloc = (claim.get("status") or {}).get("allocation") or {}
    return tuple(
        (r.get("driver", ""), r.get("pool", ""), r.get("device", ""))
        for r in (alloc.get("devices") or {}).get("results") or [])


def _taken_in(taken, driver: str, pool: str, name: str) -> bool:
    """The partition-aware membership test every allocated-set reader
    shares (live shard maps, reservation maps, snapshots, overlays):
    the exact entry, or — for a MIG device — its GPU's whole-GPU marker.
    `taken` is any container of _Entry keys."""
    if (driver, pool, name) in taken:
        return True
    parent = _parent_of(name)
    if parent != name and (driver, pool, _whole_marker(parent)) in taken:
        return True  # parent GPU wholly claimed
    return False


class PoolView:
    """Immutable allocated-set snapshot for ONE pool, built per
    scheduling attempt (``AllocationIndex.snapshot``): candidate scans
    read it lock-free instead of taking the shard lock per device. The
    scan's picks are validated by the optimistic ``try_commit`` — the
    view may go stale the instant it is built; stale picks surface as
    commit conflicts, never as double allocations."""

    __slots__ = ("pool", "taken", "mutations")

    def __init__(self, pool: str, taken: frozenset, mutations: int):
        self.pool = pool
        self.taken = taken
        self.mutations = mutations  # shard generation at snapshot time

    def is_taken(self, driver: str, name: str,
                 overlay: Optional[Set[_Entry]] = None) -> bool:
        if _taken_in(self.taken, driver, self.pool, name):
            return True
        return bool(overlay) and _taken_in(overlay, driver, self.pool, name)


class _IndexShard:
    """One pool-hash shard of the AllocationIndex: its own lock, claim
    map, refcounted taken set (keyed pool → entry → count), per-claim
    RV high-water marks, mutation generation, reservation overlay and
    dirty flag. All ``*_locked`` methods run under ``self._lock``."""

    RV_RETENTION = 4096  # evicted-claim watermarks kept (FIFO)

    def __init__(self):
        self._lock = threading.Lock()
        self._by_claim: Dict[str, Tuple[_Entry, ...]] = {}
        self._taken: Dict[str, Dict[_Entry, int]] = {}  # pool -> counts
        self._nreal: Dict[str, int] = {}  # pool -> live device results
        # Per-claim resourceVersion high-water mark: the scheduler
        # applies its OWN writes synchronously (mutation-cache style),
        # so the watch event for an EARLIER state of the same claim can
        # arrive afterwards on the informer thread — applying it would
        # roll the allocation back and let another pod double-allocate
        # the device. Numeric-RV monotonicity guards every apply/remove.
        self._rv: Dict[str, int] = {}
        # FIFO of keys whose allocation is gone but whose watermark is
        # retained (anti-resurrection for in-flight stale events). The
        # steady state is designed to NEVER resync, so without eviction
        # one watermark per claim-ever-seen would leak; beyond the
        # horizon a stale event for the claim can no longer be in
        # flight, so the oldest watermarks are safe to drop.
        self._removed: "deque[str]" = deque()
        # Bumped on every EFFECTIVE mutation: lets a resync detect that
        # an informer-thread apply/remove landed between its lister
        # snapshot and its swap (which would otherwise be silently
        # resurrected by the wholesale replace), and stamps PoolView
        # snapshots.
        self._mutations = 0
        # In-flight optimistic commits: claim key -> (pool, entries).
        # Reservations hold picked devices between try_commit and the
        # post-write apply; they are NOT part of _by_claim (a stale
        # watch replay must not be able to evict one) and resyncs
        # preserve them (cluster truth does not know them yet).
        self._reserved: Dict[str, Tuple[str, Tuple[_Entry, ...]]] = {}
        self._reserved_taken: Dict[str, Dict[_Entry, int]] = {}
        self.dirty = False
        self.dirty_reason = ""
        # True between begin_resync clearing the dirty flag and the
        # rebuilt state swapping in: the shard is KNOWN-divergent but no
        # longer flagged, so optimistic commits must keep refusing it
        # (a missed-allocation divergence makes the index vouch for a
        # taken device as free — try_commit's live re-validation checks
        # the index itself, which is exactly what cannot be trusted
        # here). Scans stay lock-free and unblocked; only the commit
        # step conflicts, bounded by the caller's requeue discipline.
        self.resyncing = False

    # -- refcounted taken bookkeeping (callers hold self._lock) -------------

    def _bump_locked(self, table: Dict[str, Dict[_Entry, int]],
                     expanded: List[_Entry], delta: int) -> None:
        for e in expanded:
            counts = table.setdefault(e[1], {})
            n = counts.get(e, 0) + delta
            if n > 0:
                counts[e] = n
            else:
                counts.pop(e, None)
                if not counts:
                    table.pop(e[1], None)

    def _set_entries_locked(self, key: str,
                            old: Optional[Tuple[_Entry, ...]],
                            new: Tuple[_Entry, ...]) -> None:
        self._mutations += 1
        if old:
            self._bump_locked(self._taken, _expand(old), -1)
            for e in old:
                self._nreal[e[1]] = self._nreal.get(e[1], 1) - 1
        if new:
            self._bump_locked(self._taken, _expand(new), +1)
            for e in new:
                self._nreal[e[1]] = self._nreal.get(e[1], 0) + 1
            self._by_claim[key] = new
        elif old is not None:
            self._by_claim.pop(key, None)

    def _note_removed_locked(self, key: str) -> List[str]:
        """Returns watermark keys evicted past the retention horizon
        (the caller drops their routing homes outside this lock)."""
        evicted: List[str] = []
        self._removed.append(key)
        while len(self._removed) > self.RV_RETENTION:
            old = self._removed.popleft()
            if old not in self._by_claim:  # not re-created since
                self._rv.pop(old, None)
                evicted.append(old)
        return evicted

    def _stale_locked(self, key: str, rv: Optional[int]) -> bool:
        if rv is None:
            return False
        if rv < self._rv.get(key, 0):
            return True
        self._rv[key] = rv
        return False

    def mark_dirty(self, reason: str) -> None:
        with self._lock:
            self.dirty = True
            self.dirty_reason = reason


class AllocationIndex:
    """Incremental allocated-device index, maintained from ResourceClaim
    add/update/delete events instead of re-listing all claims per
    scheduling attempt, **sharded by node pool**: entries
    route to ``crc32(pool) % n_shards``, each shard with its own lock,
    RV high-water marks, mutation generation and dirty flag, so a
    resync on one shard never blocks scans or applies on another.

    Holds only extracted string tuples (never references to cache
    objects), refcounted so that two MIG claims on one GPU keep the
    parent-GPU block marker alive until BOTH release. ``apply`` is
    idempotent per claim key (replace semantics), which makes informer
    relists — which re-dispatch adds for every object — safe to feed
    straight in.

    A claim's entries all live on one pool (allocation is per-node), so
    one claim maps to one shard; ``_homes`` remembers the routing for
    entry-less applies/removes (deallocations, deletes) whose pool is
    no longer derivable from the claim body. ``dirty`` (per shard)
    flags a known divergence (a dropped watch event, a failed apply):
    allocation must not proceed until the dirty shards are rebuilt from
    a full claim listing (the guarded fallback)."""

    def __init__(self, n_shards: int = 8):
        self._n_shards = max(1, int(n_shards))
        self._shards = [_IndexShard() for _ in range(self._n_shards)]
        # claim key -> pool, for routing entry-less mutations.
        # Deliberately UNLOCKED: every access is a single CPython dict
        # op (get/set/pop/C-level copy/update), each atomic under the
        # GIL, and no invariant spans two of them — a lock here sat on
        # the hot path of every apply/remove from every worker AND the
        # informer thread, and measured as a top convoy point.
        self._homes: Dict[str, str] = {}

    # ONE resourceVersion parse for both halves of the mutation-cache
    # discipline: the informer's STALE guard and this index's watermark
    # must agree on ordering or one layer accepts what the other rejects.
    _rv_int = staticmethod(Informer._rv_int)

    @property
    def n_shards(self) -> int:
        return self._n_shards

    def shard_of(self, pool: str) -> int:
        return zlib.crc32(pool.encode()) % self._n_shards

    # -- routing -------------------------------------------------------------

    def _drop_homes(self, keys: List[str], shard_id: int) -> None:
        """Drop routing for keys whose watermark was evicted from
        ``shard_id`` — but only while the recorded home still routes
        THERE. After a cross-pool move the claim lives in another
        shard; churn in the old shard must not delete the live claim's
        routing, or later entry-less deallocs/deletes become
        unroutable and leave phantom entries no resync ever flags."""
        for key in keys:
            pool = self._homes.get(key)
            if pool is not None and self.shard_of(pool) == shard_id:
                self._homes.pop(key, None)

    # -- mutation -----------------------------------------------------------

    def _checked_shard(self, key: str, pool: str) -> _IndexShard:
        """Consult the per-shard fault seam; a fired fault marks the
        target shard dirty (it is about to diverge from the event the
        caller drops) and raises for the caller's resync path."""
        shard = self._shards[self.shard_of(pool)]
        try:
            FAULTS.check("sched.shard_apply", claim=key, pool=pool)
        except FaultInjected:
            shard.mark_dirty("shard apply fault")
            raise
        return shard

    def apply(self, claim: Dict) -> None:
        """Add/replace one claim's allocation. Consults the
        ``sched.index_apply`` (pre-routing) and ``sched.shard_apply``
        (post-routing) fault sites — a raised fault leaves the shard
        UNCHANGED (the caller resyncs; shard_apply marks the shard
        dirty itself). Applies carrying an older resourceVersion than
        already indexed are ignored (see _IndexShard._rv).

        A claim whose allocation MOVED pools (deallocated out-of-band,
        re-allocated elsewhere) routes to the new pool's shard; the
        previous home's shard is purged of the leftover entries — but
        only AFTER the new shard accepted the apply, so a stale replay
        carrying the old pool can neither repoint the routing nor evict
        the live state."""
        key = claim_key(claim)
        FAULTS.check("sched.index_apply", claim=key)
        entries = claim_entries(claim)
        prev = self._homes.get(key)
        pool = entries[0][1] if entries else prev
        if pool is None:
            return  # never allocated: no entries, no watermark to guard
        shard = self._checked_shard(key, pool)
        rv = self._rv_int(claim)
        evicted: List[str] = []
        with shard._lock:
            if shard._stale_locked(key, rv):
                return
            old = shard._by_claim.get(key)
            if old != entries:
                shard._set_entries_locked(key, old, entries)
                if not entries and old is not None:
                    evicted = shard._note_removed_locked(key)
        # Accepted: commit the routing, then clean a cross-pool move's
        # leftovers out of the previous home's shard (same shard was
        # handled by the replace above). The purged key cannot drop its
        # own just-committed home: that home routes to the new shard,
        # which _drop_homes's shard check excludes.
        if entries:
            self._homes[key] = pool
            if prev is not None and self.shard_of(prev) != self.shard_of(pool):
                self._drop_homes(self._purge_shard(prev, key, rv),
                                 self.shard_of(prev))
        self._drop_homes(evicted, self.shard_of(pool))

    def _purge_shard(self, pool: str, key: str, rv: Optional[int],
                     force: bool = False) -> List[str]:
        """Drop `key`'s entries from `pool`'s shard (cross-pool move
        cleanup), guarded by that shard's OWN watermark: template claims
        reuse deterministic names, so a delayed DELETED replay from a
        deleted-and-recreated claim's prior incarnation routes here via
        its old body and must not evict the recreated claim's live
        allocation. ``force`` mirrors remove()'s own-delete semantics.
        Returns watermark keys evicted past retention."""
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            if force:
                if rv:
                    shard._rv[key] = max(shard._rv.get(key, 0), rv)
            elif shard._stale_locked(key, rv):
                return []
            shard._mutations += 1  # watermark advance alone must also
            #   invalidate an in-flight resync snapshot
            old = shard._by_claim.get(key)
            if old is None:
                return []
            shard._set_entries_locked(key, old, ())
            return shard._note_removed_locked(key)

    def remove(self, claim: Dict, force: bool = False) -> None:
        """Drop a claim's allocation. ``force=True`` is for the
        scheduler mirroring its OWN client.delete (the delete's RV is
        unknowable — the verb returns nothing), so the staleness guard
        is bypassed and the high-water mark advanced to at least the
        deleted object's RV; single-writer discipline makes that safe."""
        key = claim_key(claim)
        FAULTS.check("sched.index_apply", claim=key)
        entries = claim_entries(claim)
        prev = self._homes.get(key)
        pool = entries[0][1] if entries else prev
        if pool is None:
            return
        shard = self._checked_shard(key, pool)
        rv = self._rv_int(claim)
        with shard._lock:
            if force:
                if rv:
                    shard._rv[key] = max(shard._rv.get(key, 0), rv)
            elif shard._stale_locked(key, rv):
                return
            shard._mutations += 1  # watermark advance alone must also
            #   invalidate an in-flight resync snapshot
            old = shard._by_claim.get(key)
            if old is not None:
                shard._set_entries_locked(key, old, ())
            evicted = shard._note_removed_locked(key)
        # A deleted claim is gone everywhere: if the event's entries and
        # the recorded home disagree on the shard (a cross-pool move
        # whose cleanup raced this delete), purge the home's shard too.
        if prev is not None and self.shard_of(prev) != self.shard_of(pool):
            self._drop_homes(self._purge_shard(prev, key, rv, force),
                             self.shard_of(prev))
        self._drop_homes(evicted, self.shard_of(pool))

    # -- optimistic snapshot commit ------------------------------------------

    def snapshot(self, pool: str) -> PoolView:
        """Immutable allocated-set view of `pool` (live entries plus
        in-flight reservations) for one lock-free candidate scan."""
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            taken = frozenset(shard._taken.get(pool, ())) | frozenset(
                shard._reserved_taken.get(pool, ()))
            return PoolView(pool, taken, shard._mutations)

    def try_commit(self, pool: str,
                   staged: List[Tuple[str, Tuple[_Entry, ...]]]
                   ) -> Optional[bool]:
        """Atomically reserve every staged (claim key, entries) pick on
        `pool`, all-or-nothing, re-validating each device against the
        LIVE shard state (the snapshot the picks came from may have
        gone stale). False = device-level conflict: a device is taken
        or reserved by another claim, the shard is dirty/mid-rebuild,
        or the ``sched.snapshot_commit`` fault fired — a re-scan
        against a fresh snapshot can win. None = CLAIM-level conflict
        (also falsy): a staged key another worker already committed
        DIFFERENT entries for, or holds an in-flight reservation on
        (two pods sharing one unallocated claim) — overwriting the
        live reservation would strand its devices' refcounts, and
        re-scanning cannot help because the caller's claim COPY is
        stale; only a re-fetch resolves it. Entries the shard already
        holds for the same key (an idempotent retry after a partial
        write) pass vacuously and are not re-reserved."""
        if FAULTS.fires("sched.snapshot_commit"):
            SCHED_SNAPSHOT_CONFLICTS.inc()
            return False
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            if shard.dirty or shard.resyncing:
                # Known-divergent shard: the live re-validation below
                # would check the very state that cannot be trusted.
                # Refuse; the requeued attempt lands after the rebuild.
                SCHED_SNAPSHOT_CONFLICTS.inc()
                return False
            pending: Set[_Entry] = set()
            to_reserve: List[Tuple[str, Tuple[_Entry, ...]]] = []
            taken = shard._taken.get(pool, {})
            reserved = shard._reserved_taken.get(pool, {})
            for key, entries in staged:
                cur = shard._by_claim.get(key)
                if cur == entries:
                    continue  # already committed (idempotent retry)
                if cur is not None or key in shard._reserved:
                    # The claim is allocated to other devices, or a
                    # sibling worker's reservation is in flight: the
                    # caller's copy was stale.
                    SCHED_SNAPSHOT_CONFLICTS.inc()
                    return None
                for driver, _pool, name in entries:
                    if (_taken_in(taken, driver, pool, name)
                            or _taken_in(reserved, driver, pool, name)
                            or _taken_in(pending, driver, pool, name)):
                        SCHED_SNAPSHOT_CONFLICTS.inc()
                        return False
                pending.update(_expand(entries))
                to_reserve.append((key, entries))
            for key, entries in to_reserve:
                shard._reserved[key] = (pool, entries)
                shard._bump_locked(shard._reserved_taken,
                                   _expand(entries), +1)
        return True

    def release(self, pool: str, keys: Iterable[str]) -> None:
        """Drop the reservations `try_commit` took for `keys` — after
        the real allocations were applied (the entries now live in
        ``_by_claim``), or after the claim write failed (the devices
        return to the free set)."""
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            for key in keys:
                held = shard._reserved.pop(key, None)
                if held is not None:
                    shard._bump_locked(shard._reserved_taken,
                                       _expand(held[1]), -1)

    def allocated_count(self, pool: str) -> int:
        """Live device results on `pool` (committed + reserved) — the
        busy-node skip: a candidate whose count already matches its
        published device count cannot fit anything, no scan needed."""
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            n = shard._nreal.get(pool, 0)
            for key, (held_pool, entries) in shard._reserved.items():
                # A key already applied to _by_claim (the window between
                # _after_claim_write and the caller's release) is in
                # _nreal — counting its reservation too would double it
                # and make the busy-node skip pass over free capacity.
                if held_pool == pool and key not in shard._by_claim:
                    n += len(entries)
            return n

    # -- dirty flags + resync ------------------------------------------------

    @property
    def dirty(self) -> bool:
        return any(s.dirty for s in self._shards)

    @property
    def dirty_reason(self) -> str:
        for s in self._shards:
            if s.dirty and s.dirty_reason:
                return s.dirty_reason
        return ""

    def mark_all_dirty(self, reason: str) -> None:
        """A divergence that cannot be attributed to one shard (a
        dropped watch event for an unknown claim): every shard must
        resync before allocation proceeds."""
        for s in self._shards:
            s.mark_dirty(reason)

    def mark_shard_dirty(self, shard_id: int, reason: str) -> None:
        self._shards[shard_id].mark_dirty(reason)

    def dirty_shards(self) -> List[int]:
        return [i for i, s in enumerate(self._shards) if s.dirty]

    def begin_resync(self, shard_id: Optional[int] = None) -> None:
        """Clear the dirty flag(s) BEFORE the caller takes its claim
        snapshot: a concurrent mark_dirty whose dropped event postdates
        the snapshot then re-dirties the shard and its queued resync
        re-runs — clearing after the swap would clobber that mark and
        leave the shard divergent forever."""
        shards = (self._shards if shard_id is None
                  else [self._shards[shard_id]])
        for shard in shards:
            with shard._lock:
                shard.dirty = False
                shard.dirty_reason = ""
                # Commits stay refused until the rebuilt state swaps in
                # (cleared by _swap_shard; re-marking dirty also covers
                # the swap-refused tail — see _full_resync).
                shard.resyncing = True

    def mutation_count(self, shard_id: Optional[int] = None) -> int:
        if shard_id is not None:
            shard = self._shards[shard_id]
            with shard._lock:
                return shard._mutations
        total = 0
        for shard in self._shards:
            with shard._lock:
                total += shard._mutations
        return total

    def _shard_state_from(self, claims: Iterable[Dict],
                          shard_id: Optional[int]):
        """Fresh (by_claim, taken, nreal, rvs, homes) rebuilt from a
        claim listing — restricted to `shard_id` when given. Watermarks
        for entry-less claims route via the recorded home (a stale
        allocated event for them would route by its entries' pool, so
        the watermark must live in that same shard)."""
        by_claim: Dict[str, Tuple[_Entry, ...]] = {}
        taken: Dict[str, Dict[_Entry, int]] = {}
        nreal: Dict[str, int] = {}
        rvs: Dict[str, int] = {}
        homes: Dict[str, str] = {}
        old_homes = dict(self._homes)  # C-level copy: atomic under GIL
        for claim in claims:
            key = claim_key(claim)
            entries = claim_entries(claim)
            pool = entries[0][1] if entries else old_homes.get(key)
            if pool is None:
                continue  # never allocated: nothing to rebuild
            if shard_id is not None and self.shard_of(pool) != shard_id:
                continue
            homes[key] = pool
            rv = self._rv_int(claim)
            if rv:
                rvs[key] = rv
            if not entries:
                continue
            by_claim[key] = entries
            for e in entries:
                nreal[e[1]] = nreal.get(e[1], 0) + 1
            for e in _expand(entries):
                counts = taken.setdefault(e[1], {})
                counts[e] = counts.get(e, 0) + 1
        return by_claim, taken, nreal, rvs, homes

    def _swap_shard(self, shard_id: int, state,
                    only_if_mutations: Optional[int],
                    deleted: Optional[Dict[str, int]] = None) -> bool:
        shard = self._shards[shard_id]
        by_claim, taken, nreal, rvs, homes = state
        with shard._lock:
            if (only_if_mutations is not None
                    and shard._mutations != only_if_mutations):
                return False
            # Watermarks only move forward. The listing is the cache at
            # one instant, but deltas dispatched before it may still wait
            # in the informer's shard FIFOs: a claim deleted before the
            # listing is absent from it, and dropping its watermark let
            # such a delta re-add the claim's devices with no later
            # event to remove them (a shed DELETED delta is what queued
            # this very resync). Deletions the informer saw (key -> the
            # deletion's RV) raise the mark past every state the claim
            # had, in every rebuilt shard: a queued delta routes by its
            # own pool, which the index may never have seen.
            gone: List[str] = []
            for key, rv in list(shard._rv.items()) + list(
                    (deleted or {}).items()):
                if key in by_claim or rv <= rvs.get(key, 0):
                    continue
                if key not in rvs and key not in shard._rv:
                    gone.append(key)
                rvs[key] = rv
            shard._by_claim = by_claim
            shard._taken = taken
            shard._nreal = nreal
            shard._rv = rvs
            evicted: List[str] = []
            for key in gone:
                evicted += shard._note_removed_locked(key)
            # The swap is itself a mutation: a CONCURRENT resync of the
            # same shard holding an older listing must see its
            # only_if_mutations guard trip rather than silently clobber
            # this fresher state.
            shard._mutations += 1
            shard.resyncing = False
        self._drop_homes(evicted, shard_id)
        # Routing hygiene: the rebuild is the authoritative home set for
        # this shard. A key routing HERE but absent from the listing was
        # deleted during the divergence window — it never re-enters the
        # eviction FIFO (cleared above), so without this prune its
        # _homes entry leaks for the scheduler's lifetime. Re-read the
        # value at pop time: a concurrent apply may have just repointed
        # the key's routing to another shard (same discipline as
        # _drop_homes).
        for key, pool in list(self._homes.items()):
            if key in homes or self.shard_of(pool) != shard_id:
                continue
            if self._homes.get(key) is pool:
                self._homes.pop(key, None)
        self._homes.update(homes)
        return True

    def resync(self, claims: Iterable[Dict]) -> bool:
        """Rebuild EVERY shard from a full claim listing (sync mode /
        tests; call begin_resync first). Deliberately does NOT consult
        the fault sites: this IS the recovery path — an armed apply
        fault must not be able to starve it. Does NOT touch the dirty
        flags (see begin_resync). Reservations are preserved — cluster
        truth does not know in-flight commits yet."""
        listing = list(claims)
        for sid in range(len(self._shards)):
            self._swap_shard(sid, self._shard_state_from(listing, sid),
                             None)
        return True

    def resync_shard(self, shard_id: int, claims: Iterable[Dict],
                     only_if_mutations: Optional[int] = None,
                     deleted: Optional[Dict[str, int]] = None) -> bool:
        """Rebuild ONE shard from a full claim listing (the guarded
        fallback's unit: sibling shards keep applying and scanning).

        only_if_mutations: the shard's mutation_count() read BEFORE the
        caller took its claim snapshot; the swap is refused (returns
        False) when a concurrent apply/remove landed in between —
        wholesale replacement would silently resurrect what that
        mutation changed (e.g. an out-of-band claim delete).

        deleted: claim key -> the resourceVersion its deletion was seen
        at, read with the listing (Informer.list_with_tombstones); the
        rebuilt shard refuses any older state of those claims."""
        return self._swap_shard(
            shard_id, self._shard_state_from(claims, shard_id),
            only_if_mutations, deleted)

    # -- queries ------------------------------------------------------------

    def allocated_claims(self) -> List[Tuple[str, Tuple[_Entry, ...]]]:
        """Snapshot of every indexed (claim key, entries) pair, shard by
        shard — the eviction scan's worklist. Each shard is read under
        its own lock; the union is NOT a cross-shard atomic snapshot,
        which the consumer tolerates (a claim mutating mid-scan is
        re-validated against the live lister before any eviction)."""
        out: List[Tuple[str, Tuple[_Entry, ...]]] = []
        for shard in self._shards:
            with shard._lock:
                out.extend(shard._by_claim.items())
        return out

    def entries_for(self, key: str) -> Tuple[_Entry, ...]:
        pool = self._homes.get(key)
        if pool is None:
            return ()
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            return shard._by_claim.get(key, ())

    def is_taken(self, driver: str, pool: str, name: str,
                 overlay: Optional[Set[_Entry]] = None) -> bool:
        shard = self._shards[self.shard_of(pool)]
        with shard._lock:
            if _taken_in(shard._taken.get(pool, ()), driver, pool, name):
                return True
            if _taken_in(shard._reserved_taken.get(pool, ()),
                         driver, pool, name):
                return True
        return bool(overlay) and _taken_in(overlay, driver, pool, name)

    def diff_against(self, claims: Iterable[Dict]) -> List[str]:
        """Divergences between the live index and a ground-truth claim
        listing (chaos invariant: after quiesce, empty) — checked PER
        SHARD (a claim indexed in the wrong shard is a divergence even
        if the global union looks right) and globally."""
        want_by_shard: Dict[int, Dict[str, Tuple[_Entry, ...]]] = {}
        for claim in claims:
            entries = claim_entries(claim)
            if entries:
                sid = self.shard_of(entries[0][1])
                want_by_shard.setdefault(sid, {})[claim_key(claim)] = entries
        out = []
        for sid, shard in enumerate(self._shards):
            with shard._lock:
                have = dict(shard._by_claim)
            want = want_by_shard.get(sid, {})
            for key in sorted(set(want) | set(have)):
                if want.get(key) != have.get(key):
                    out.append(f"shard {sid}: index[{key}]="
                               f"{have.get(key)} != truth {want.get(key)}")
        return out


class _Unscheduled(Exception):
    """Internal: transient condition (conflict, missing object) — let the
    workqueue retry with backoff."""


class Scheduler:
    """See module docstring. ``resync_interval`` is the event-mode
    safety-net cadence at which still-pending pods are
    re-nudged; ``gc_sweep_interval`` paces the low-frequency orphan-claim
    sweep backing the event-driven GC; ``workers`` sizes the event-mode
    reconcile pool (default ``TPU_DRA_SCHED_WORKERS`` or 4: per-key
    serialization keeps same-pod/same-gc items exclusive, the snapshot
    commit keeps cross-worker picks conflict-free); ``index_shards``
    shards the allocation index (default ``TPU_DRA_SCHED_INDEX_SHARDS``
    or 8)."""

    SYNC_TIMEOUT = 10.0
    # Fresh-snapshot re-scans after an optimistic commit conflict before
    # the pod item falls back to a backoff requeue.
    COMMIT_RETRIES = 4
    # Distinct nodeSelector keys cached in _cand_cache before stale-rev
    # entries are swept (per-pod-unique selectors would otherwise grow
    # the cache for the scheduler's lifetime).
    CAND_CACHE_MAX = 1024

    def __init__(self, client: ApiClient, *, resync_interval: float = 2.0,
                 gc_sweep_interval: float = 10.0,
                 workers: Optional[int] = None,
                 index_shards: Optional[int] = None):
        self._client = client
        self._resync_interval = resync_interval
        self._gc_sweep_interval = gc_sweep_interval
        self._workers = (workers if workers is not None else
                         int(os.environ.get("TPU_DRA_SCHED_WORKERS", "4")))
        self._index_shards = (index_shards if index_shards is not None else
                              int(os.environ.get(
                                  "TPU_DRA_SCHED_INDEX_SHARDS", "8")))
        self._stop = threading.Event()
        self._raised_switch = False
        self._queue: Optional[WorkQueue] = None
        self._pool: List[threading.Thread] = []
        self._sweeper: Optional[threading.Thread] = None
        self._informers: Dict[str, Informer] = {}
        self._index = AllocationIndex(n_shards=self._index_shards)
        self._pending: Set[str] = set()
        # Subset of _pending that FAILED to place for lack of capacity:
        # the capacity-event fast path re-drives only these. Queued or
        # in-flight pods run against current state anyway, and
        # re-enqueueing the whole pending set per capacity event was
        # the control plane's top write amplifier at churn scale (every
        # claim delete fanned out O(window) queue ops).
        self._waiting: Set[str] = set()
        # Pods fully placed by us: their own bind-event echo must not
        # re-enqueue a full reconcile pass (entries leave on pod delete,
        # so the set is bounded by live placed pods).
        self._done: Set[str] = set()
        self._plock = threading.Lock()
        # DeviceClass name -> (resourceVersion, selector sources): spares
        # re-extracting selector lists per allocation; the compiled
        # programs themselves are cached process-wide in simcluster.cel.
        self._class_cache: Dict[str, Tuple[str, List[str]]] = {}
        # Node -> (slice (name, rv) fingerprint, NodeTopology|None): the
        # per-node fabric view extracted from published ResourceSlices,
        # rebuilt only when a slice's resourceVersion moves. Same
        # immutable-value sharing discipline as _class_cache.
        self._topo_cache: Dict[
            str, Tuple[tuple, Optional[placement.NodeTopology]]] = {}
        # Candidate-node cache: nodeSelector -> (node revision, sorted
        # names). Invalidated wholesale by bumping _nodes_rev from node
        # watch events — per-pod scans stop re-listing + re-sorting the
        # whole node inventory. The cached lists are shared read-only.
        self._cand_cache: Dict[tuple, Tuple[int, List[str]]] = {}
        self._nodes_rev = 0
        # Node -> (slice revision, published device count): the
        # busy-node skip's denominator (see _schedule).
        self._devcount_cache: Dict[str, Tuple[int, int]] = {}
        self._slices_rev = 0
        # Revision source for both caches: next() is atomic, so two
        # racing capacity events always land DISTINCT revisions — a
        # plain += 1 could lose one bump to a read-modify-write race
        # and leave a cache validated against the surviving value.
        self._rev_seq = itertools.count(1)
        self._started = False
        # HA mode: a standby replica runs warm informers
        # but leaves the worker pool paused until promote(); the
        # acting leader's fencing generation is stamped into every
        # claim-status/bind write (see _stamp_fence) and deliberately
        # survives deposal — install_fencing refuses the stale stamp.
        self._standby = False
        self._promote_lock = threading.Lock()
        self.lease_generation: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, standby: bool = False) -> None:
        """Event mode. ``standby=True`` brings up everything
        EXCEPT the reconcile workers and sweeper: informers sync and
        keep the index warm, events enqueue into the paused workqueue
        (per-key dedupe bounds it by live object count), and nothing
        writes to the cluster until promote() — the HA replica shape."""
        self._stop.clear()  # a restart after stop() must run
        self._standby = standby
        # Fresh state for (re)start: informers begin with empty stores,
        # so nothing would ever dispatch deletes for claims that died
        # while the scheduler was stopped — a retained index would keep
        # their devices phantom-allocated forever.
        self._index = AllocationIndex(n_shards=self._index_shards)
        with self._plock:
            self._pending.clear()
            self._waiting.clear()
            self._done.clear()
        self._class_cache.clear()
        self._topo_cache.clear()
        self._cand_cache.clear()
        self._devcount_cache.clear()
        self._queue = WorkQueue(
            # No global token bucket: event enqueues are explicit-delay
            # (after=0) and failures back off per item; a bucket would
            # throttle churn-scale nudge fan-in for no protection (the
            # "apiserver" here is in-process or the fake).
            rate_limiter=ExponentialFailureRateLimiter(0.005, 2.0),
            log=lambda msg: log.debug("workqueue: %s", msg),
            name="sched")

        inf = {}
        for name, gvr in (("pods", PODS), ("claims", RESOURCECLAIMS),
                          ("slices", RESOURCESLICES),
                          ("classes", DEVICECLASSES), ("nodes", NODES)):
            if name == "claims":
                # Partitioned by allocation pool with AllocationIndex's
                # crc32 shard function: informer shard i feeds exactly
                # index shard i, so claim deltas of one node pool apply
                # in order on one FIFO while other pools run free, and a
                # shed delta dirties precisely the shard it would have fed.
                inf[name] = Informer(
                    self._client, gvr,
                    copy_on_read=False, copy_events=False,
                    partitions=self._index_shards,
                    partition_key=self._claim_pool,
                    shard_queue_cap=int(os.environ.get(
                        "TPU_DRA_SCHED_SHARD_QUEUE_CAP", "4096")),
                    on_shard_overflow=self._on_informer_shard_overflow)
            else:
                inf[name] = Informer(self._client, gvr,
                                     copy_on_read=False, copy_events=False)
        inf["claims"].add_indexer("owner", self._owner_index)
        inf["slices"].add_indexer("node", self._slice_node_index)

        inf["pods"].on_add(self._on_pod)
        inf["pods"].on_update(lambda old, new: self._on_pod(new))
        inf["pods"].on_delete(self._on_pod_deleted)
        inf["claims"].on_add(lambda obj: self._on_claim(None, obj))
        inf["claims"].on_update(self._on_claim)
        inf["claims"].on_delete(self._on_claim_deleted)
        for src in ("slices", "nodes"):
            inf[src].on_add(lambda obj, s=src: self._on_capacity(s))
            inf[src].on_update(lambda o, n, s=src: self._on_capacity(s))
            inf[src].on_delete(lambda obj, s=src: self._on_capacity(s))
        inf["classes"].on_add(lambda obj: self._on_class(obj))
        inf["classes"].on_update(lambda o, n: self._on_class(n))
        inf["classes"].on_delete(lambda obj: self._on_class(obj))

        self._informers = inf
        self._started = True
        # CPython GIL tuning for the lock-heavy event control plane: the
        # 5 ms default switch interval preempts lock holders mid-critical-
        # section, convoying every waiter behind them; 20 ms lets critical
        # sections complete between forced switches. Process-global, so
        # raise/restore is refcounted module-wide.
        _raise_switch_interval()
        self._raised_switch = True
        for i in inf.values():
            i.start()
        for i in inf.values():
            i.wait_for_sync(self.SYNC_TIMEOUT)
        # The pool starts once every informer has synced: an evict scan
        # queued by the first slice events must not read a node lister
        # that has not listed yet (every pool would look lost). Its
        # workers serialize per key (infra.workqueue); cross-worker
        # allocation safety comes from the snapshot commit step. A
        # standby leaves the pool paused — promote() starts it.
        if not self._standby:
            self._start_pool()
        # The initial claim listing flowed through _on_claim adds during
        # informer sync, so the index is already built; the nudge below
        # only covers pods whose add events raced the pending-set wiring.
        self._nudge_all_pending()
        if not self._standby:
            self._sweeper = threading.Thread(target=self._sweep_loop,
                                             daemon=True,
                                             name="sim-scheduler-sweep")
            self._sweeper.start()

    def _start_pool(self) -> None:
        self._pool = self._queue.start_workers(self._workers, self._stop)
        SCHED_WORKERS.set(self._workers)

    @property
    def is_standby(self) -> bool:
        return self._standby

    def set_lease_generation(self, generation: int) -> None:
        """Adopt the elector's fencing token: every subsequent
        claim-status/bind write carries it (never cleared — a deposed
        leader's stale stamp is exactly what fencing refuses)."""
        self.lease_generation = generation

    def promote(self) -> None:
        """Standby -> acting leader (the elector's on_started_leading).
        The informers are already warm; what takeover owes is DISTRUST:
        every shard of the AllocationIndex is marked dirty and rebuilt
        through the existing guarded _full_resync path before the
        worker pool starts committing — the old leader may have
        allocated right up to its deposal, and commits against a
        pre-takeover index are how devices double-allocate."""
        with self._promote_lock:
            if not self._standby or self._stop.is_set() \
                    or self._queue is None:
                return
            self._standby = False
        t0 = time.monotonic()
        try:
            # Injection site: the takeover rebuild itself fails —
            # promotion must re-drive the resync, never proceed dirty.
            FAULTS.check("sched.takeover_resync")
            self._index.mark_all_dirty("lease takeover")
            self._full_resync()
        except FaultInjected:
            # Declared degradation (sched.takeover_resync): the queued
            # resync item re-runs the rebuild; until it converges,
            # dirty shards refuse try_commit, so the promoted workers
            # degrade to bounded requeues rather than unsafe commits.
            self.request_resync("takeover resync faulted")
        self._start_pool()
        self._nudge_all_pending()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True,
                                         name="sim-scheduler-sweep")
        self._sweeper.start()
        log.info("promoted to acting leader in %.3fs (generation %s)",
                 time.monotonic() - t0, self.lease_generation)

    def stop(self) -> None:
        self._stop.set()
        for i in self._informers.values():
            i.stop()
        if self._queue is not None:
            self._queue.shutdown()
        for t in self._pool + [self._sweeper]:
            if t is not None:
                t.join(timeout=5)
        self._pool = []
        if self._raised_switch:
            self._raised_switch = False
            _restore_switch_interval()
        self._started = False

    # -- event handlers (watch threads: derive keys, enqueue, return) -------

    @staticmethod
    def _owner_index(obj: Dict) -> List[str]:
        owner = (obj.get("metadata", {}).get("annotations") or {}).get(
            "sim/owner-pod")
        if not owner:
            return []
        ns = obj["metadata"].get("namespace", "default")
        return [f"{ns}/{owner}"]

    @staticmethod
    def _slice_node_index(obj: Dict) -> List[str]:
        node = (obj.get("spec") or {}).get("nodeName")
        return [node] if node else []

    def _drop_event(self, resource: str) -> bool:
        """The sched.watch_event chaos seam: a fired site models the
        scheduler mishandling this event. The event is dropped BUT the
        index is marked dirty — the guard knows it dropped something, so
        the full-resync fallback takes over before the next allocation
        (that is what makes the fallback 'guarded')."""
        if FAULTS.fires("sched.watch_event"):
            self._mark_dirty(f"watch event dropped ({resource})")
            return True
        SCHED_WATCH_EVENTS.inc(labels={"resource": resource})
        return False

    def _on_pod(self, pod: Dict) -> None:
        if self._drop_event("pods"):
            return
        if pod["metadata"].get("deletionTimestamp"):
            return
        key = self._pod_key(pod)
        phase = (pod.get("status") or {}).get("phase", "Pending")
        if phase not in ("", "Pending"):
            self._forget_pod(key)
            return
        if pod["spec"].get("nodeName"):
            with self._plock:
                if key in self._done:
                    return  # our own bind/status echo: already placed
        self._enqueue_pod(key)

    def _on_pod_deleted(self, pod: Dict) -> None:
        if self._drop_event("pods"):
            return
        key = self._pod_key(pod)
        self._forget_pod(key)
        # Event-driven claim GC: the resourceclaim controller's ownerRef
        # analog, fired from the delete event instead of a 150ms
        # full-list poll; the periodic sweep stays as the safety net.
        self._queue.enqueue(key, self._gc_pod_claims, key=f"gc/{key}",
                            after=0, dedupe=True)

    def _on_claim(self, old: Optional[Dict], new: Dict) -> None:
        if self._drop_event("resourceclaims"):
            return
        try:
            self._index.apply(new)
        except FaultInjected as e:
            self._mark_dirty_from(e, "index apply failed")
            return
        if old is not None and claim_entries(old) and not claim_entries(new):
            self._nudge_pending_pods()  # deallocation freed devices

    @staticmethod
    def _claim_pool(claim: Dict) -> Optional[str]:
        """Partition key for the partitioned claims informer: the pool
        of the claim's allocation, i.e. exactly what AllocationIndex
        shards by — claim deltas ride the informer shard that feeds
        their index shard. Unallocated claims return None and fall back
        to the informer's name-hash routing (they carry no entries, so
        any shard is equally correct for them)."""
        entries = claim_entries(claim)
        return entries[0][1] if entries else None

    def _on_informer_shard_overflow(self, shard_id: int, reason: str) -> None:
        """Recovery hook for a shed claims-informer delta: the shard's
        slice of the allocation index missed an apply/remove, so mark
        exactly that index shard dirty (try_commit refuses dirty shards
        — no allocation can race the gap) and queue the guarded resync.
        If even this path faults (sched.informer_shard_relist), degrade
        to dirtying the whole index: over-resync is safe, a clean-
        looking shard that lost deltas is not."""
        why = f"informer shard {shard_id} overflow ({reason})"
        try:
            FAULTS.check("sched.informer_shard_relist", shard=shard_id)
            self._index.mark_shard_dirty(shard_id, why)
            self._enqueue_resync(why)
        except FaultInjected:
            self._mark_dirty(why)

    def _on_claim_deleted(self, claim: Dict) -> None:
        if self._drop_event("resourceclaims"):
            return
        try:
            self._index.remove(claim)
        except FaultInjected as e:
            self._mark_dirty_from(e, "index remove failed")
            return
        # A deleted claim may free devices — and if its owner pod is
        # still alive (out-of-band deletion), that pod needs re-driving
        # so its template claim is recreated.
        owner = (claim.get("metadata", {}).get("annotations") or {}).get(
            "sim/owner-pod")
        if owner:
            ns = claim["metadata"].get("namespace", "default")
            self._enqueue_pod(f"{ns}/{owner}")
        self._nudge_pending_pods()

    def _on_capacity(self, resource: str) -> None:
        # Cache invalidation happens even for DROPPED events: the drop
        # models the scheduler mishandling the event downstream, but a
        # candidate/devcount cache left stale here would outlive the
        # guarded resync that recovers everything else.
        if resource == "nodes":
            self._nodes_rev = next(self._rev_seq)
        else:
            self._slices_rev = next(self._rev_seq)
        if self._drop_event(resource):
            return
        self._nudge_pending_pods()
        # Failure-domain reaction: the same events that ADD capacity also
        # take it away — a node delete, or a ResourceSlice shrinking
        # because the driver's health pipeline yanked a GPU. The
        # keyed+deduped evict-scan item sweeps the allocation index for
        # claims whose devices no longer exist and releases them through
        # the real deallocation pipeline.
        if self._queue is not None:
            self._queue.enqueue(resource, lambda _o: self._evict_scan(),
                                key="evict", after=0, dedupe=True)

    def _on_class(self, dc: Dict) -> None:
        if self._drop_event("deviceclasses"):
            return
        self._class_cache.pop(dc["metadata"]["name"], None)
        self._nudge_pending_pods()

    # -- queue plumbing ------------------------------------------------------

    @staticmethod
    def _pod_key(pod: Dict) -> str:
        return (f"{pod['metadata'].get('namespace', 'default')}/"
                f"{pod['metadata']['name']}")

    def _enqueue_pod(self, key: str) -> None:
        with self._plock:
            self._pending.add(key)
            self._waiting.discard(key)  # the enqueue below covers it
            self._done.discard(key)
        self._queue.enqueue(key, self._process_pod, key=f"pod/{key}",
                            after=0, dedupe=True)

    def _forget_pod(self, key: str, done: bool = False) -> None:
        with self._plock:
            self._pending.discard(key)
            self._waiting.discard(key)
            if done:
                self._done.add(key)
            else:
                self._done.discard(key)

    def _nudge_pending_pods(self) -> None:
        """Capacity-event fast path: re-drive the pods a previous
        attempt could NOT place (see _waiting). dedupe=True collapses
        event-storm fan-in to one queued item per pod. A free landing
        while a pod's failing attempt is still mid-flight can slip past
        this (the pod joins _waiting only after the attempt returns) —
        the periodic sweep re-drives the whole pending set to close
        that window."""
        with self._plock:
            if not self._waiting:
                return
            keys = sorted(self._waiting)
            self._waiting.clear()
        for key in keys:
            self._queue.enqueue(key, self._process_pod, key=f"pod/{key}",
                                after=0, dedupe=True)

    def _nudge_all_pending(self) -> None:
        """The sweep's safety net: re-drive EVERY still-pending pod
        (kept off the event fast path)."""
        with self._plock:
            keys = sorted(self._pending)
        for key in keys:
            self._queue.enqueue(key, self._process_pod, key=f"pod/{key}",
                                after=0, dedupe=True)

    def _mark_dirty(self, reason: str, *, attributed: bool = False) -> None:
        """attributed=True: the divergence already marked its OWN shard
        dirty (the sched.shard_apply seam does so before raising), so
        only the resync item needs queueing. Otherwise the divergence
        cannot be pinned to one shard — a dropped watch event for a
        claim whose pool we never saw — and every shard must rebuild."""
        if not attributed:
            self._index.mark_all_dirty(reason)
        self._enqueue_resync(reason)

    def _mark_dirty_from(self, e: FaultInjected, reason: str) -> None:
        """The FaultInjected catch sites' shared attribution rule:
        sched.shard_apply self-marks its shard (see _checked_shard);
        anything else cannot be pinned to one shard."""
        self._mark_dirty(reason, attributed=e.site == "sched.shard_apply")

    def _enqueue_resync(self, reason: str) -> None:
        if self._queue is not None:
            self._queue.enqueue(reason, lambda _: self._full_resync(),
                                key="resync", after=0, dedupe=True)

    def request_resync(self, reason: str = "requested") -> None:
        """Public seam (chaos op): force the guarded full-resync path."""
        self._mark_dirty(reason)

    def _full_resync(self) -> None:
        """The guarded fallback, per shard: rebuild every DIRTY shard of
        the allocation index from the informer caches (which self-heal
        via relist even when the SCHEDULER mishandled events) and
        re-drive everything pending. Clean shards are untouched — their
        scans and commits flow throughout the rebuild. Counted — the
        bench asserts steady state never comes here."""
        dirty = self._index.dirty_shards()
        if not dirty:
            return
        SCHED_FULL_RELISTS.inc()
        reason = self._index.dirty_reason
        # Clear-dirty BEFORE the snapshot: a drop landing after the
        # listing re-dirties the shard and its own queued resync
        # re-runs. `resyncing` stays set until the swap, so optimistic
        # commits keep refusing the shards meanwhile.
        for sid in dirty:
            self._index.begin_resync(sid)
        # ONE claim listing per retry round, shared by every dirty
        # shard (an unattributed divergence dirties all of them — at
        # fleet scale per-shard listings multiplied the recovery cost
        # by the shard count). The per-shard only_if_mutations guard
        # still reads each shard's generation before the listing.
        failed = list(dirty)
        for _ in range(8):
            gens = {sid: self._index.mutation_count(sid) for sid in failed}
            listing, deleted = self._list_claims_with_tombstones()
            failed = [sid for sid in failed
                      if not self._index.resync_shard(
                          sid, listing, only_if_mutations=gens[sid],
                          deleted=deleted)]
            if not failed:
                break
        SCHED_SHARD_RESYNCS.inc(len(dirty) - len(failed))
        if failed:
            # Concurrent mutations kept invalidating the snapshots
            # (effective handler-side changes are rare, so this is an
            # extreme tail): re-mark just those shards and retry through
            # the queue rather than spin.
            for sid in failed:
                self._index.mark_shard_dirty(
                    sid, "resync raced concurrent index mutations")
            self._enqueue_resync("resync raced concurrent index mutations")
            return
        with self._plock:
            self._pending.clear()
            self._waiting.clear()  # subset of _pending; a stale key here
            #   would spuriously re-drive a placed pod on capacity events
            self._done.clear()  # conservatively re-verify placed pods
        for pod in self._list_pods():
            if pod["metadata"].get("deletionTimestamp"):
                continue
            phase = (pod.get("status") or {}).get("phase", "Pending")
            if phase in ("", "Pending"):
                self._enqueue_pod(self._pod_key(pod))
        log.info("resync of shards %s completed (%s)", dirty, reason)

    def _sweep_loop(self) -> None:
        next_gc = time.monotonic() + self._gc_sweep_interval
        while not self._stop.wait(self._resync_interval):
            self._nudge_all_pending()
            if time.monotonic() >= next_gc:
                next_gc = time.monotonic() + self._gc_sweep_interval
                self._queue.enqueue(
                    "sweep", lambda _: self._gc_sweep(),
                    key="gc-sweep", after=0, dedupe=True)
                # Eviction safety net, same shape as the GC sweep: a
                # DROPPED capacity event (sched.watch_event) would
                # otherwise be the last trigger a dead GPU's claims
                # ever get — the periodic sweep guarantees the evict
                # scan converges regardless.
                self._queue.enqueue(
                    "sweep", lambda _: self._evict_scan(),
                    key="evict", after=0, dedupe=True)

    # -- data access (lister-backed when started, client-backed sync) --------

    def _list_pods(self) -> List[Dict]:
        if self._started:
            return self._informers["pods"].lister.list()
        return self._client.list(PODS)

    def _list_claims(self) -> List[Dict]:
        if self._started:
            return self._informers["claims"].lister.list()
        return self._client.list(RESOURCECLAIMS)

    def _list_claims_with_tombstones(self) -> Tuple[List[Dict],
                                                    Dict[str, int]]:
        if self._started:
            return self._informers["claims"].list_with_tombstones()
        return self._client.list(RESOURCECLAIMS), {}

    def _get_pod(self, ns: str, name: str) -> Optional[Dict]:
        if self._started:
            return self._informers["pods"].lister.get(name, ns)
        try:
            return self._client.get(PODS, name, ns)
        except NotFoundError:
            return None

    def _get_claim(self, ns: str, name: str) -> Optional[Dict]:
        if self._started:
            return self._informers["claims"].lister.get(name, ns)
        try:
            return self._client.get(RESOURCECLAIMS, name, ns)
        except NotFoundError:
            return None

    def _iter_nodes(self) -> List[Dict]:
        nodes = (self._informers["nodes"].lister.list() if self._started
                 else self._client.list(NODES))
        return sorted(nodes, key=lambda n: n["metadata"]["name"])

    def _slices_for_node(self, node: str) -> List[Dict]:
        if self._started:
            return self._informers["slices"].get_by_index("node", node)
        return [sl for sl in self._client.list(RESOURCESLICES)
                if (sl.get("spec") or {}).get("nodeName") == node]

    def _get_class(self, name: str) -> Optional[Dict]:
        if self._started:
            return self._informers["classes"].lister.get(name)
        try:
            return self._client.get(DEVICECLASSES, name)
        except NotFoundError:
            return None

    # -- sync mode -----------------------------------------------------------

    def reconcile_once(self) -> None:
        """One poll-and-scan pass (sync mode): full-list Pods and
        ResourceClaims, rebuild a transient allocation index, GC orphans,
        drive every pending pod. Event mode makes this the exception —
        each call counts on tpu_dra_sched_full_relists."""
        SCHED_FULL_RELISTS.inc()
        pods = self._client.list(PODS)
        claims = self._client.list(RESOURCECLAIMS)
        gced = self._gc_orphan_claims(pods, claims, path="sweep")
        self._index.begin_resync()
        self._index.resync(c for c in claims if claim_key(c) not in gced)
        for pod in pods:
            if pod["metadata"].get("deletionTimestamp"):
                continue
            phase = (pod.get("status") or {}).get("phase", "Pending")
            if phase not in ("", "Pending"):
                continue
            try:
                pod = self._ensure_claims_from_templates(pod)
                self._schedule(pod)
            except (ConflictError, _Unscheduled):
                continue  # racing another write: next pass retries

    # -- claim GC -------------------------------------------------------------

    def _gc_pod_claims(self, key: str) -> None:
        """Event path: the pod named by `key` is gone; delete the claims
        it owns (owner index lookup, no listing)."""
        for claim in self._informers["claims"].get_by_index("owner", key):
            self._delete_claim(claim, path="event")

    def _gc_sweep(self) -> None:
        """Safety-net sweep over the informer caches (NOT an apiserver
        list): catches claims whose pod-delete event was missed."""
        self._gc_orphan_claims(self._list_pods(), self._list_claims(),
                               path="sweep")

    def _gc_orphan_claims(self, pods: List[Dict], claims: List[Dict],
                          path: str = "sweep") -> Set[str]:
        """The resourceclaim controller's ownerRef GC analog: a claim
        generated from a template dies with its pod — otherwise exclusive
        devices (channel-0, the daemon device) stay allocated forever and
        the next workload can never schedule. Returns the keys of the
        claims deleted (so a sync pass excludes them from its index)."""
        alive = {(p["metadata"].get("namespace", "default"),
                  p["metadata"]["name"]) for p in pods
                 if not p["metadata"].get("deletionTimestamp")}
        gced: Set[str] = set()
        for claim in claims:
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if not owner:
                continue
            ns = claim["metadata"].get("namespace", "default")
            if (ns, owner) not in alive:
                self._delete_claim(claim, path=path)
                gced.add(claim_key(claim))
        return gced

    def _delete_claim(self, claim: Dict, path: str) -> None:
        ns = claim["metadata"].get("namespace", "default")
        name = claim["metadata"]["name"]
        try:
            self._client.delete(RESOURCECLAIMS, name, ns)
        except NotFoundError:
            return
        # Mirror our own delete into the index synchronously (the write
        # half of the mutation-cache discipline): with creates, status
        # writes AND deletes all applied on the worker thread, the
        # informer-thread handlers only ever replay states the index has
        # already seen — so a full resync can never race a real mutation.
        try:
            self._index.remove(claim, force=True)
        except FaultInjected as e:
            self._mark_dirty_from(e, "index remove failed (own delete)")
        SCHED_CLAIMS_GCED.inc(labels={"path": path})
        log.info("GC claim %s/%s via %s (owner pod gone)", ns, name, path)

    # -- failure-domain eviction (worker thread) -----------------------------

    def _evict_scan(self) -> None:
        """Sweep the allocation index for claims whose allocated devices
        no longer exist — the node is gone, or the device vanished from
        the node's published ResourceSlices (GPU quarantined/yanked by
        the driver's health pipeline) — and evict them through the REAL
        deallocation pipeline: a claim-status write (allocation removed,
        eviction reason recorded) mirrored via _after_claim_write, then
        the owner pod unbound and re-driven. The index is never edited
        directly: the write IS the eviction, exactly like GC's delete.

        Raises on a per-claim failure (sched.evict fault, write
        conflict): the keyed evict item retries with backoff and
        re-scans — eviction must converge, not half-apply."""
        nodes_alive = {n["metadata"]["name"] for n in self._iter_nodes()}
        published: Dict[str, Set[str]] = {}
        for key, entries in self._index.allocated_claims():
            reason = None
            for _driver, pool, dev in entries:
                if pool not in nodes_alive:
                    reason = "node_lost"
                    break
                devs = published.get(pool)
                if devs is None:
                    devs = {d["name"]
                            for sl in self._slices_for_node(pool)
                            for d in (sl.get("spec") or {}).get(
                                "devices") or []}
                    published[pool] = devs
                if dev not in devs:
                    reason = "device_lost"
                    break
            if reason is None:
                continue
            # Injection site: the eviction itself fails mid-flight — the
            # scan item must retry until the claim is released, never
            # leave it half-evicted or pinned to the dead GPU.
            FAULTS.check("sched.evict", claim=key, reason=reason)
            self._evict_claim(key, entries, reason)
        # Healing pass: an eviction is two writes (claim deallocation,
        # pod unbind) and only the first is found by the index scan
        # above — if the unbind failed (write conflict) or the pod
        # re-bound against a claim the scan had not deallocated yet,
        # the owner is left bound to an evicted, unallocated claim and
        # NOTHING above would ever revisit it. Every scan therefore
        # re-enforces the second half: evicted + unallocated + owner
        # still bound -> unbind and re-drive. Idempotent and O(claims).
        for claim in self._list_claims():
            status = claim.get("status") or {}
            if status.get("allocation") or "evicted" not in status:
                continue
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if not owner:
                continue
            ns = claim["metadata"].get("namespace", "default")
            pod = self._get_pod(ns, owner)
            if pod is not None and pod["spec"].get("nodeName"):
                self._release_pod_binding(
                    f"{ns}/{owner}",
                    (status["evicted"] or {}).get("reason", "evicted"))

    def _evict_claim(self, key: str,
                     entries: Tuple[_Entry, ...], reason: str) -> None:
        ns, name = key.split("/", 1)
        claim = self._get_claim(ns, name)
        if claim is None or claim_entries(claim) != entries:
            return  # stale scan entry: the claim already moved on
        upd = json_deepcopy(claim)
        status = upd.setdefault("status", {})
        status.pop("allocation", None)
        status["evicted"] = {
            "reason": reason,
            "message": f"allocated devices lost ({reason}): "
                       f"{sorted(e[2] for e in entries)}"}
        self._stamp_fence(upd)
        try:
            updated = self._client.update_status(RESOURCECLAIMS, upd, ns)
        except (ConflictError, NotFoundError) as e:
            raise _Unscheduled(f"evict {key}: {e}") from e
        # Mutation-cache discipline, same as every scheduler write: the
        # index learns the deallocation from the write, not from a
        # direct shard edit.
        self._after_claim_write(updated)
        SCHED_EVICTIONS.inc(labels={"reason": reason})
        log.warning("evicted claim %s (%s): devices %s no longer "
                    "published", key, reason,
                    sorted(e[2] for e in entries))
        owner = (claim["metadata"].get("annotations") or {}).get(
            "sim/owner-pod")
        if owner:
            self._release_pod_binding(f"{ns}/{owner}", reason)

    def _release_pod_binding(self, key: str, reason: str) -> None:
        """Unbind the evicted claim's owner pod and re-drive it: it
        re-enters the scheduling loop and ends Allocated on surviving
        capacity, or Pending with the PodScheduled=False reason when
        nothing fits (strict topology refusal — never a silent
        shrink)."""
        ns, name = key.split("/", 1)
        pod = self._get_pod(ns, name)
        if pod is None or pod["metadata"].get("deletionTimestamp"):
            return
        if pod["spec"].get("nodeName"):
            upd = json_deepcopy(pod)
            upd["spec"]["nodeName"] = ""
            try:
                updated = self._client.update(PODS, upd, ns)
            except (ConflictError, NotFoundError) as e:
                raise _Unscheduled(f"unbind {key}: {e}") from e
            if self._started:
                self._informers["pods"].update_cache(updated)
            self._set_pod_reason(
                key, "Evicted",
                f"allocated devices lost ({reason}); rescheduling")
        self._enqueue_pod(key)

    @staticmethod
    def _pod_sched_condition(pod: Dict) -> Optional[Dict]:
        for cond in (pod.get("status") or {}).get("conditions") or []:
            if cond.get("type") == "PodScheduled":
                return cond
        return None

    def _set_pod_reason(self, key: str, reason: str, message: str) -> None:
        """Record why the pod is not scheduled as a PodScheduled=False
        condition (Pending-with-reason). Reason/message are only written
        when they change — the failed-attempt path runs repeatedly and
        must not amplify writes. Best-effort: a conflict is retried by
        the next failed attempt."""
        ns, name = key.split("/", 1)
        pod = self._get_pod(ns, name)
        if pod is None or pod["metadata"].get("deletionTimestamp"):
            return
        cur = self._pod_sched_condition(pod)
        if cur is not None and cur.get("status") == "False" \
                and cur.get("reason") == reason:
            return
        upd = json_deepcopy(pod)
        conds = [c for c in (upd.setdefault("status", {}).get(
            "conditions") or []) if c.get("type") != "PodScheduled"]
        conds.append({"type": "PodScheduled", "status": "False",
                      "reason": reason, "message": message})
        upd["status"]["conditions"] = conds
        try:
            updated = self._client.update_status(PODS, upd, ns)
        except (ConflictError, NotFoundError):
            return
        if self._started:
            self._informers["pods"].update_cache(updated)

    def _clear_pod_reason(self, pod: Dict) -> None:
        """The pod bound: flip its PodScheduled condition True (drop the
        stale Pending/Evicted reason). Skipped when no False condition
        was ever recorded — the common placement path stays one write."""
        cur = self._pod_sched_condition(pod)
        if cur is None or cur.get("status") == "True":
            return
        ns = pod["metadata"].get("namespace", "default")
        upd = json_deepcopy(pod)
        conds = [c for c in (upd.setdefault("status", {}).get(
            "conditions") or []) if c.get("type") != "PodScheduled"]
        conds.append({"type": "PodScheduled", "status": "True"})
        upd["status"]["conditions"] = conds
        try:
            updated = self._client.update_status(PODS, upd, ns)
        except (ConflictError, NotFoundError):
            return
        if self._started:
            self._informers["pods"].update_cache(updated)

    # -- per-pod reconcile (worker thread) ------------------------------------

    def _process_pod(self, key: str) -> None:
        # A known-divergent shard must rebuild before its commits flow;
        # the inline call keeps single-worker schedulers converging
        # without waiting for the queued resync item, but only there: on
        # a pool, every worker inlining it would race concurrent full
        # listings and swap-thrash each other's only_if_mutations guards
        # (the keyed, deduped "resync" item already serializes recovery).
        # A still-dirty (or mid-rebuild) shard refuses try_commit, so a
        # pod whose pool is divergent degrades to a bounded
        # conflict/requeue, never allocates against untrusted state.
        if self._workers <= 1 and self._index.dirty:
            self._full_resync()
        ns, name = key.split("/", 1)
        pod = self._get_pod(ns, name)
        if pod is None or pod["metadata"].get("deletionTimestamp"):
            self._forget_pod(key)
            return
        phase = (pod.get("status") or {}).get("phase", "Pending")
        if phase not in ("", "Pending"):
            self._forget_pod(key)
            return
        try:
            pod = self._ensure_claims_from_templates(pod)
            done = self._schedule(pod)
        except (ConflictError, _Unscheduled) as e:
            raise _Unscheduled(str(e)) from e  # workqueue retries w/ backoff
        if done:
            self._forget_pod(key, done=True)
        else:
            # Stays pending; capacity events (via _waiting) / the
            # periodic sweep re-drive it — no busy retry for genuinely
            # unschedulable pods.
            with self._plock:
                if key in self._pending:
                    self._waiting.add(key)
            # Pending-with-reason: the refusal is recorded
            # on the pod, so "waiting for capacity" is observable —
            # strict topology refusal must read as a reasoned Pending,
            # never a silent hang. Written only on change.
            self._set_pod_reason(
                key, "Unschedulable",
                "no node can satisfy the pod's claims (insufficient "
                "free capacity or no contiguous topology cuboid)")

    # -- resourceclaim controller analog --------------------------------------

    def _ensure_claims_from_templates(self, pod: Dict) -> Dict:
        """Create template-backed claims the pod is missing; returns the
        (possibly refreshed) pod object. Zero-copy discipline: `pod` may
        be a lister view — it is deepcopied before any mutation."""
        ns = pod["metadata"].get("namespace", "default")
        statuses = ((pod.get("status") or {})
                    .get("resourceClaimStatuses") or [])
        known = {s["name"]: s["resourceClaimName"] for s in statuses}
        changed = False
        for entry in (pod["spec"].get("resourceClaims") or []):
            if entry.get("resourceClaimName"):
                continue
            tmpl_name = entry.get("resourceClaimTemplateName")
            if not tmpl_name:
                continue
            if entry["name"] in known:
                # Status says the claim exists; recreate it if it was
                # deleted out-of-band while the pod lives on.
                if self._get_claim(ns, known[entry["name"]]) is not None:
                    continue
            try:
                rct = self._client.get(RESOURCECLAIMTEMPLATES, tmpl_name, ns)
            except NotFoundError:
                continue  # template not stamped yet; retried by nudge
            claim_name = known.get(entry["name"]) or (
                f"{pod['metadata']['name']}-{entry['name']}")
            claim = {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {
                    "name": claim_name, "namespace": ns,
                    "labels": dict((rct["metadata"].get("labels") or {})),
                    "annotations": {
                        "resource.kubernetes.io/pod-claim-name":
                            entry["name"],
                        "sim/owner-pod": pod["metadata"]["name"]},
                },
                "spec": (rct.get("spec") or {}).get("spec") or {},
            }
            try:
                created = self._client.create(RESOURCECLAIMS, claim,
                                              namespace=ns)
                self._after_claim_write(created)
            except (ConflictError, AlreadyExistsError):
                pass  # racing create (retry, superseded worker): converged
            known[entry["name"]] = claim_name
            changed = True
        if changed:
            upd = json_deepcopy(pod)
            upd.setdefault("status", {})["resourceClaimStatuses"] = [
                {"name": k, "resourceClaimName": v}
                for k, v in sorted(known.items())]
            pod = self._client.update_status(PODS, upd, ns)
            if self._started:
                self._informers["pods"].update_cache(pod)
        return pod

    # -- allocation + binding -------------------------------------------------

    def _schedule(self, pod: Dict) -> bool:
        """Returns True when the pod is fully placed (bound, claims
        allocated); False when it must wait for capacity."""
        ns = pod["metadata"].get("namespace", "default")
        claims = self._pod_claims(pod, ns)
        if claims is None:
            raise _Unscheduled("claim object missing")  # retried
        needs_alloc = any(
            not (c.get("status") or {}).get("allocation") for c in claims)
        node_name = pod["spec"].get("nodeName")
        candidates = ([node_name] if node_name
                      else self._candidate_nodes(pod))
        for node in candidates:
            if (needs_alloc and not node_name
                    and self._index.allocated_count(node)
                    >= self._published_device_count(node)):
                # Busy-node skip: every published device on this node is
                # consumed (each allocated result takes at least one
                # distinct published device, so count >= published means
                # full) — no snapshot scan or CEL evaluation needed. At
                # fleet scale the sorted candidate walk otherwise burns
                # its time re-scanning the same leading busy nodes.
                continue
            if self._try_allocate_all(claims, node):
                if not node_name:
                    upd = json_deepcopy(pod)
                    upd["spec"]["nodeName"] = node
                    updated = self._client.update(PODS, upd, ns)
                    if self._started:
                        self._informers["pods"].update_cache(updated)
                    SCHED_PODS_BOUND.inc()
                    # A pod that carried a Pending/Evicted reason is now
                    # placed: flip the condition so "Pending-with-reason"
                    # only ever describes pods that are actually waiting.
                    self._clear_pod_reason(updated)
                return True
        return False

    def _pod_claims(self, pod: Dict, ns: str) -> Optional[List[Dict]]:
        statuses = {s["name"]: s["resourceClaimName"] for s in
                    ((pod.get("status") or {})
                     .get("resourceClaimStatuses") or [])}
        out = []
        for entry in (pod["spec"].get("resourceClaims") or []):
            name = entry.get("resourceClaimName") or statuses.get(
                entry["name"])
            if name is None:
                # Template-backed claim not created yet.
                if entry.get("resourceClaimTemplateName"):
                    return None
                continue
            claim = self._get_claim(ns, name)
            if claim is None:
                return None
            out.append(claim)
        return out

    def _candidate_nodes(self, pod: Dict) -> List[str]:
        selector = pod["spec"].get("nodeSelector") or {}
        ck = tuple(sorted(selector.items()))
        names: Optional[List[str]] = None
        # The selector->names cache spares re-listing + re-sorting the
        # whole node inventory per scheduling attempt (O(n log n) at 5k
        # nodes). `rev` is read BEFORE the listing: an event landing
        # mid-listing stores the entry under the pre-event revision, so
        # the next lookup recomputes rather than trusting a torn view.
        # Event mode only — sync mode has no events to bump revisions.
        rev = self._nodes_rev
        if self._started:
            cached = self._cand_cache.get(ck)
            if cached is not None and cached[0] == rev:
                names = cached[1]
        if names is None:
            names = []
            for node in self._iter_nodes():
                labels = node["metadata"].get("labels") or {}
                if all(labels.get(k) == v for k, v in selector.items()):
                    names.append(node["metadata"]["name"])
            if self._started:
                if len(self._cand_cache) >= self.CAND_CACHE_MAX:
                    # Sweep superseded-revision entries (dead weight —
                    # lookups miss on the rev check); if every entry is
                    # current the workload really has this many live
                    # selectors, so start over rather than grow without
                    # bound. list() snapshots atomically under the GIL
                    # (sibling workers insert concurrently).
                    for k, v in list(self._cand_cache.items()):
                        if v[0] != rev:
                            self._cand_cache.pop(k, None)
                    if len(self._cand_cache) >= self.CAND_CACHE_MAX:
                        self._cand_cache.clear()
                self._cand_cache[ck] = (rev, names)
        if (len(names) > 1
                and featuregates.enabled(
                    featuregates.TopologyAwareScheduling)):
            # Inter-node NVLink adjacency: group candidates by the clique
            # their GPUs report, biggest clique first, worker
            # order within — the pods of a multi-node ComputeDomain then
            # fill ONE slice in rank order instead of scattering across
            # slices in node-name order.
            infos = []
            for name in names:
                topo = self._node_topology(name)
                infos.append((name, topo.clique_id if topo else "",
                              topo.worker_index if topo else 0))
            return placement.rank_candidate_nodes(infos)
        return names

    def _node_topology(self, node: str) -> Optional[placement.NodeTopology]:
        """This node's fabric view (block + device-name<->coord maps) from
        its published ResourceSlices; None when the node publishes no
        usable coordinates. Cached against the slices' resourceVersions.
        Worker-thread only."""
        slices = self._slices_for_node(node)
        key = tuple(sorted(
            (sl["metadata"]["name"],
             sl["metadata"].get("resourceVersion", "")) for sl in slices))
        cached = self._topo_cache.get(node)
        if cached is not None and cached[0] == key:
            return cached[1]
        topo = placement.node_topology_from_slices(slices)
        self._topo_cache[node] = (key, topo)
        return topo

    def _published_device_count(self, node: str) -> int:
        """Total devices this node's ResourceSlices publish — the
        busy-node skip's denominator. Cached against the slice revision
        in event mode (sync mode recomputes: nothing bumps the revision
        there)."""
        rev = self._slices_rev
        if self._started:
            cached = self._devcount_cache.get(node)
            if cached is not None and cached[0] == rev:
                return cached[1]
        count = sum(len((sl.get("spec") or {}).get("devices") or ())
                    for sl in self._slices_for_node(node))
        if self._started:
            self._devcount_cache[node] = (rev, count)
        return count

    def _try_allocate_all(self, claims: List[Dict], node: str) -> bool:
        """Allocate every unallocated claim on `node`; all-or-nothing per
        pod (claims already allocated elsewhere pin the pod implicitly:
        a shared pre-allocated claim simply must exist on this node).

        Snapshot discipline: availability is read from one
        immutable PoolView built per attempt — no index lock is held
        across the scan — plus a staging overlay for this pod's own
        picks. The picks then commit optimistically: ``try_commit``
        re-validates every device against the live shard and reserves
        them all-or-nothing. A conflict (another worker took a device
        first, the shard is mid-resync, or the sched.snapshot_commit
        fault fired) re-scans against a fresh snapshot — which now sees
        the winner's reservation — up to COMMIT_RETRIES times before
        the pod item falls back to a backoff requeue."""
        for _attempt in range(self.COMMIT_RETRIES):
            view = self._index.snapshot(node)
            overlay: Set[_Entry] = set()
            staged: List[Tuple[Dict, Dict, str, Tuple[_Entry, ...]]] = []
            for claim in claims:
                alloc = (claim.get("status") or {}).get("allocation")
                if alloc:
                    # Shared claim already allocated: usable only if it
                    # landed on this node's pool.
                    pools = {r.get("pool") for r in
                             (alloc.get("devices") or {}).get("results")
                             or []}
                    if pools and node not in pools:
                        return False
                    continue
                allocation = self._allocate(claim, node, view, overlay)
                if allocation is None:
                    return False
                entries = tuple(
                    (r["driver"], r["pool"], r["device"])
                    for r in allocation["devices"]["results"])
                staged.append((claim, allocation, claim_key(claim),
                               entries))
            if not staged:
                return True  # nothing to place: already allocated
            committed = self._index.try_commit(
                node, [(k, e) for _c, _a, k, e in staged])
            if committed:
                break
            if committed is None:
                # Claim-level conflict: a sibling worker allocated or
                # reserved one of these very claims, so the local claim
                # bodies are stale — every retry would stage the same
                # outdated copy and conflict deterministically (the
                # fresh snapshot changes the DEVICE picks, not the
                # claim). Skip the guaranteed-futile rescans; the
                # backoff requeue's claim re-fetch resolves it.
                raise _Unscheduled(
                    f"claim copies went stale under commit on {node}")
            # Device conflict: the shard moved underneath the snapshot.
            # Loop — the fresh view includes whatever won.
        else:
            raise _Unscheduled(
                f"snapshot commit kept conflicting on {node}")
        try:
            for claim, allocation, _k, _e in staged:
                # Per-claim trace root: sched.pod_seen →
                # sched.allocate, the allocate span's traceparent
                # stamped into the claim annotations in the SAME status
                # write (K8s status subresource carries metadata) — the
                # node driver, prepare pipeline, CDI env export and
                # mesh builder all continue this trace.
                t_root = TRACER.begin(
                    "sched.pod_seen", root=True,
                    attributes={"claim": claim_key(claim), "node": node})
                t_alloc = TRACER.begin("sched.allocate", parent=t_root)
                written = False
                try:
                    upd = json_deepcopy(claim)
                    upd.setdefault("status", {})["allocation"] = \
                        allocation
                    # Re-allocation supersedes a prior eviction: the
                    # marker must describe the claim's CURRENT state or
                    # not exist.
                    upd["status"].pop("evicted", None)
                    tp = t_alloc.traceparent()
                    if tp:
                        upd["metadata"].setdefault(
                            "annotations", {})[TRACEPARENT_ANNOTATION] \
                            = tp
                    # The commit: fenced — a deposed leader reaching
                    # here late gets a ConflictError, not a landed
                    # allocation.
                    self._stamp_fence(upd)
                    updated = self._client.update_status(
                        RESOURCECLAIMS, upd,
                        upd["metadata"].get("namespace"))
                    self._after_claim_write(updated)
                    written = True
                finally:
                    if written:
                        t_alloc.end()
                        t_root.end()
                    else:
                        t_alloc.abandon("allocation write failed")
                        t_root.abandon("allocation write failed")
        finally:
            # Reservations end when the real allocations are indexed
            # (success: _after_claim_write applied them) or when the
            # write failed (the devices return to the free set and the
            # requeued attempt re-picks).
            self._index.release(node, [k for _c, _a, k, _e in staged])
        return True

    def _stamp_fence(self, upd: Dict) -> None:
        """Stamp the acting leader's lease generation into a
        claim-status write the fencing reactor guards (allocation +
        evict — the scheduler's commits; ResourceClaims have no other
        status writer, so the stamp only ever meets fencing-aware
        paths). Pod writes stay unstamped: pods are co-written by
        nodesim, and a stale stamp riding a deepcopy round-trip would
        fence an innocent writer. No-op outside HA mode (no elector
        ever set a generation) — the single-process paths pay
        nothing."""
        if self.lease_generation is not None:
            upd["metadata"].setdefault("annotations", {})[
                FENCING_ANNOTATION] = str(self.lease_generation)

    def _after_claim_write(self, obj: Dict) -> None:
        """Mutation-cache discipline for the scheduler's own writes: the
        informer cache AND the allocation index see the write before the
        watch event lands — the index never lags the scheduler's own
        allocations, which is what makes single-writer allocation safe
        on an event-driven cache. (In sync mode the index update keeps
        later pods in the SAME pass from re-picking the devices.)"""
        if self._started:
            self._informers["claims"].update_cache(obj)
        try:
            self._index.apply(obj)
        except FaultInjected as e:
            self._mark_dirty_from(e, "index apply failed (own write)")

    def _allocate(self, claim: Dict, node: str, view: PoolView,
                  overlay: Set[_Entry]) -> Optional[Dict]:
        devices = (claim.get("spec") or {}).get("devices") or {}
        results = []
        for req in devices.get("requests") or []:
            exact = req.get("exactly") or req  # v1 wrapper or flat
            class_name = exact.get("deviceClassName", "")
            count = int(exact.get("count") or 1)
            sources = self._class_selector_sources(class_name)
            if sources is None:
                return None
            # Per-request selectors AND with the class's (the real
            # allocator's semantics: every selector must match;
            # gpu-test6-style attribute selection rides here).
            sources = sources + [
                (sel.get("cel") or {}).get("expression", "")
                for sel in exact.get("selectors") or []]
            progs = cel.compile_many(sources)
            if progs is None:
                return None  # a broken selector selects nothing
            picked = self._pick_devices(node, progs, count, view, overlay)
            if picked is None:
                return None
            for driver, dev in picked:
                overlay.update(_expand([(driver, node, dev)]))
                results.append({"request": req["name"], "driver": driver,
                                "pool": node, "device": dev})
        if not results:
            return None
        config = [{"source": "FromClaim", **entry}
                  for entry in devices.get("config") or []]
        return {"devices": {"results": results, "config": config},
                "nodeSelector": {"nodeSelectorTerms": [{"matchFields": [
                    {"key": "metadata.name", "operator": "In",
                     "values": [node]}]}]}}

    def _class_selector_sources(self, name: str) -> Optional[List[str]]:
        """All CEL expressions of the DeviceClass (None if the class does
        not exist — the claim is unallocatable, not unconstrained),
        cached per (name, resourceVersion)."""
        dc = self._get_class(name)
        if dc is None:
            self._class_cache.pop(name, None)
            return None
        rv = dc["metadata"].get("resourceVersion", "")
        cached = self._class_cache.get(name)
        if cached is not None and cached[0] == rv:
            return cached[1]
        sources = [(sel.get("cel") or {}).get("expression", "")
                   for sel in (dc.get("spec") or {}).get("selectors") or []]
        self._class_cache[name] = (rv, sources)
        return sources

    def _pick_devices(self, node: str, progs: List["cel.Program"],
                      count: int, view: PoolView, overlay: Set[_Entry]
                      ) -> Optional[List[Tuple[str, str]]]:
        """Devices on `node` matching EVERY compiled CEL program, as
        (driver, name) pairs. CEL is evaluated for real against the
        published attributes (simcluster.cel): a wrong attribute name or
        type mismatch selects nothing instead of everything.
        Availability reads the caller's immutable PoolView — the scan
        holds no index lock; stale reads surface as commit conflicts.

        Iteration is deterministic — slices and devices are scanned in
        name order — so first-fit picks and topology scores reproduce
        across runs and chaos seeds regardless of dict/watch ordering.

        With the TopologyAwareScheduling gate on, multi-GPU requests on
        a node that publishes GPU coordinates take the topology-scored
        path: the pick must be a contiguous block, chosen by the
        fragmentation score (topology.placement.best_placement). No block
        fits -> the claim WAITS (None) rather than degrade to a
        scattered allocation; nodes without usable topology keep
        first-fit (counted as fallback)."""
        gate_on = (count > 1 and featuregates.enabled(
            featuregates.TopologyAwareScheduling))
        # A node with no usable topology keeps the first-fit early exit
        # even under the gate: scanning its whole inventory just to fall
        # back would turn O(count) picks into O(devices) on every
        # coordinate-less node (mixed fleets, sysfs without topology/).
        topo = self._node_topology(node) if gate_on else None
        topo_path = topo is not None
        available: List[Tuple[str, str]] = []
        for sl in sorted(self._slices_for_node(node),
                         key=lambda s: s["metadata"]["name"]):
            spec = sl.get("spec") or {}
            driver = spec.get("driver", "")
            for dev in sorted(spec.get("devices") or [],
                              key=lambda d: d["name"]):
                if not all(p.matches(dev, driver) for p in progs):
                    continue
                if view.is_taken(driver, dev["name"], overlay=overlay):
                    continue
                available.append((driver, dev["name"]))
                if not topo_path and len(available) == count:
                    if gate_on:
                        TOPO_ALLOCS.inc(labels={"outcome": "fallback"})
                    return available  # first-fit: done at count
        if len(available) < count:
            return None
        if not topo_path:
            return available[:count]
        return self._pick_topology(topo, available, count)

    def _pick_topology(self, topo: "placement.NodeTopology",
                       available: List[Tuple[str, str]],
                       count: int) -> Optional[List[Tuple[str, str]]]:
        """Topology-scored pick over the CEL-matched free devices."""
        if any(name not in topo.coord_of for _d, name in available):
            # The match includes devices the GPU block cannot lay out
            # (MIG devices, foreign drivers): no fabric model for this
            # request — first-fit, honestly counted.
            TOPO_ALLOCS.inc(labels={"outcome": "fallback"})
            return available[:count]
        free = {topo.coord_of[name] for _d, name in available}
        with Timer(TOPO_SCORE_SECONDS):
            placed = placement.best_placement(topo.fabric, free, count)
            if placed is not None:
                # Observed inside the timed region: the free-cuboid scan
                # is the same order of work as the placement scan, and
                # leaving it outside would under-attribute the topology
                # path's real per-pick overhead.
                TOPO_FREE_CUBOID.observe(placement.max_free_cuboid(
                    topo.fabric, free.difference(placed)))
        if placed is None:
            TOPO_ALLOCS.inc(labels={"outcome": "unplaceable"})
            return None  # wait for a contiguous window, never scatter
        TOPO_ALLOCS.inc(labels={"outcome": "contiguous"})
        driver_of = dict((name, drv) for drv, name in available)
        return [(driver_of[topo.name_of[c]], topo.name_of[c])
                for c in placed]

    # -- introspection --------------------------------------------------------

    def verify_index(self) -> List[str]:
        """Divergences between the incremental index and cluster truth
        (a fresh apiserver claim listing); empty = consistent. Chaos
        invariant after quiesce."""
        return self._index.diff_against(self._client.list(RESOURCECLAIMS))

    def verify_topology(self) -> List[str]:
        """Topology invariants against cluster truth (chaos, after
        quiesce): (1) every allocated multi-GPU claim on a node that
        publishes coordinates is a contiguous block; (2) for each
        such node, the free coordinate set DERIVED from the incremental
        AllocationIndex equals the one derived from a fresh claim
        listing — the index owns allocation state , so a
        divergent derived free-set means the topology view (mesh/coord
        cache) broke, not the bookkeeping."""
        claims = self._client.list(RESOURCECLAIMS)
        slices = self._client.list(RESOURCESLICES)
        out = placement.allocation_violations(claims, slices)
        taken_truth: Dict[str, Set[str]] = {}
        for claim in claims:
            for _driver, pool, dev in claim_entries(claim):
                taken_truth.setdefault(pool, set()).add(_parent_of(dev))
        by_node: Dict[str, List[Dict]] = {}
        for sl in slices:
            node = (sl.get("spec") or {}).get("nodeName")
            if node:
                by_node.setdefault(node, []).append(sl)
        for node in sorted(by_node):
            topo = placement.node_topology_from_slices(by_node[node])
            if topo is None:
                continue
            free_truth = {c for name, c in topo.coord_of.items()
                          if name not in taken_truth.get(node, set())}
            free_index = {c for name, c in topo.coord_of.items()
                          if not self._index.is_taken(
                              topo.driver_of[name], node, name)}
            if free_truth != free_index:
                out.append(
                    f"topology free-set on {node} diverges from the "
                    f"allocation index: index-only "
                    f"{sorted(free_index - free_truth)}, truth-only "
                    f"{sorted(free_truth - free_index)}")
        return out
