"""List+watch informer with indexers and a mutation cache (counterpart
of tpu_dra/k8s/informer.py).

``Informer`` keeps a cache of one resource from a LIST followed by a
resourceVersion-resumed WATCH (relisting, with backoff, when the stream
ends in an error such as 410 Gone), runs add/update/delete handlers,
and indexes the cache (``uid_index``, ``label_index``); ``update_cache``
is the mutation cache through which a controller sees its own writes
before their watch events land; it refuses a write older than a deletion
the watch already delivered (deletion tombstones), so a late write never
resurrects a deleted object. By default every read and every handler
gets its own copy of the cached object.

Hot read-only consumers (the sim scheduler) pass ``copy_on_read=False``
/ ``copy_events=False`` and get views of the cached objects instead;
``SHADOW`` (a ``ViewShadow``, on in the chaos walks or with
``TPU_DRA_VIEW_SHADOW=1``) content-hashes each view at hand-out and
reports any that was mutated in place. ``partitions=N`` routes handler
dispatch through a ``ShardDispatcher``: per-shard bounded FIFOs keyed by
``partition_key`` (crc32, the scheduler's index shard function), each
drained by its own worker; a full shard or the
``sched.watch_shard_dispatch`` fault sheds the delta and reports it to
``on_shard_overflow``.
"""

from __future__ import annotations

import collections
import copy
import logging
import os
import random
import sys
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DefaultRegistry as _METRICS
from tpu_dra_torch.k8s.client import ApiClient, GVR

log = logging.getLogger("tpu_dra_torch.informer")

# Stream failures are invisible by design (the loop relists), which is
# exactly why they must be counted: a flapping apiserver shows up here
# long before anything user-visible degrades.
_RELISTS = _METRICS.counter(
    "tpu_dra_informer_relists_total",
    "informer list/watch stream failures that forced a relist")

# Partitioned-dispatch drops: a shard delta FIFO hit its bound (or the
# sched.watch_shard_dispatch fault fired) and a handler invocation was
# shed. The consumer's on_shard_overflow callback owns recovery (the
# scheduler marks the shard dirty and resyncs); this counter is how a
# recovery loop that's silently doing all the work gets noticed.
_SHARD_OVERFLOWS = _METRICS.counter(
    "tpu_dra_informer_shard_overflows_total",
    "partitioned informer dispatch drops (queue bound or injected fault)")


# Sentinel returned by Informer._set for writes that lost an RV race
# (see _set); watch loops skip dispatch for them.
STALE = object()


# ---------------------------------------------------------------------------
# View shadow
# ---------------------------------------------------------------------------
# Zero-copy views must reach only read-only sinks. The shadow checks
# that in chaos runs: every view handed out (lister reads, index
# lookups, zero-copy event dispatch) is content-hashed at hand-out,
# keyed by the caller's source site; quiesce re-hashes the very same
# objects. Legitimate cache updates replace objects wholesale (watch
# events build new dicts), so a changed hash means someone mutated the
# handed-out view in place: a drift, and a chaos violation. The drift
# set exports in the reference's format (the static analysis's
# observed-vs-static seam).

class ViewShadow:
    """Bounded sampler: (object identity, hand-out site) pairs are
    recorded once with their content hash; ``verify()`` re-hashes.
    No-op unless enabled (chaos harnesses / TPU_DRA_VIEW_SHADOW=1)."""

    MAX_SAMPLES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = os.environ.get("TPU_DRA_VIEW_SHADOW") == "1"
        self._samples: Dict[Tuple[str, int], Tuple[Dict, str, str]] = {}
        self._overflow = 0
        self._drifts: List[Dict] = []

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> bool:
        """Returns the previous enabled state (harness save/restore)."""
        prev, self.enabled = self.enabled, True
        return prev

    def restore(self, prev: bool) -> None:
        self.enabled = prev

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._drifts.clear()
            self._overflow = 0

    # -- recording ----------------------------------------------------------

    @staticmethod
    def _digest(obj) -> str:
        import hashlib
        import json as _json
        try:
            blob = _json.dumps(obj, sort_keys=True, default=repr)
        except (TypeError, ValueError):
            blob = repr(obj)
        return hashlib.sha1(blob.encode()).hexdigest()

    @staticmethod
    def _caller_site() -> str:
        """relpath:line of the first frame outside this module — the
        hand-out site, keyed the way the static analyzer keys view
        reads."""
        f = sys._getframe(2)
        own = __file__
        while f is not None and f.f_code.co_filename == own:
            f = f.f_back
        if f is None:
            return "?:0"
        path = f.f_code.co_filename.replace(os.sep, "/")
        for marker in ("tpu_dra_torch/", "tests/"):
            idx = path.rfind("/" + marker)
            if idx >= 0:
                return f"{path[idx + 1:]}:{f.f_lineno}"
        return f"{path.rsplit('/', 1)[-1]}:{f.f_lineno}"

    def record(self, obj) -> None:
        if not self.enabled or not isinstance(obj, dict):
            return
        site = self._caller_site()
        key = (site, id(obj))
        with self._lock:
            if key in self._samples:
                return  # keep the EARLIEST hash: maximal drift window
            if len(self._samples) >= self.MAX_SAMPLES:
                self._overflow += 1
                return
            try:
                name = meta_namespace_key(obj)
            except KeyError:
                name = "?"
            self._samples[key] = (obj, self._digest(obj), name)

    # -- verification -------------------------------------------------------

    def verify(self) -> List[Dict]:
        """Re-hash every sampled object; new drifts are recorded AND
        returned. Idempotent per drift: a site+object pair reports
        once."""
        with self._lock:
            fresh: List[Dict] = []
            for (site, _oid), (obj, h, name) in list(self._samples.items()):
                if self._digest(obj) != h:
                    fresh.append({"site": site, "key": name})
                    del self._samples[(site, _oid)]
            self._drifts.extend(fresh)
            return fresh

    def snapshot(self) -> int:
        with self._lock:
            return len(self._drifts)

    def violations_since(self, snap: int) -> List[str]:
        self.verify()
        with self._lock:
            return [
                f"zero-copy view drift: object {d['key']!r} handed out "
                f"at {d['site']} was mutated in place (zero-copy "
                "views are read-only)"
                for d in self._drifts[snap:]]

    # -- export ---------------------------------------------------------------

    EXPORT_ENV = "TPU_DRA_VIEW_SHADOW_EXPORT"

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Merge observed drifts into the JSON file at `path` (default
        $TPU_DRA_VIEW_SHADOW_EXPORT; None = no-op). Merging mirrors the
        lock witness: several harness runs accumulate one file. An
        EMPTY export is still written — the gate reading the file
        distinguishes 'ran drift-free' from 'never ran'."""
        import json as _json
        path = path or os.environ.get(self.EXPORT_ENV)
        if not path:
            return None
        self.verify()
        with self._lock:
            drifts = {(d["site"], d["key"]) for d in self._drifts}
        try:
            with open(path, encoding="utf-8") as fh:
                for d in _json.load(fh).get("drifts", ()):
                    drifts.add((d.get("site", "?"), d.get("key", "?")))
        except (OSError, ValueError):
            pass
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                _json.dump({"drifts": [{"site": s, "key": k}
                                       for s, k in sorted(drifts)]}, fh)
            os.replace(tmp, path)
        except OSError:
            return None  # best-effort, like the witness export
        return path


def load_drifts(path: str) -> List[Dict]:
    """Read a view-shadow export for the analyzer's --check-view-shadow.
    Raises on a missing/garbled file: an absent export turning the check
    green would be the silent under-approximation it exists to catch."""
    import json as _json
    with open(path, encoding="utf-8") as fh:
        doc = _json.load(fh)
    if not isinstance(doc, dict) or not isinstance(doc.get("drifts"),
                                                   list):
        raise ValueError(f"{path}: not a view-shadow export")
    return list(doc["drifts"])


SHADOW = ViewShadow()


def meta_namespace_key(obj: Dict) -> str:
    meta = obj.get("metadata", {})
    ns = meta.get("namespace", "")
    return f"{ns}/{meta['name']}" if ns else meta["name"]


def uid_index(obj: Dict) -> List[str]:
    uid = obj.get("metadata", {}).get("uid")
    return [uid] if uid else []


def label_index(label: str) -> Callable[[Dict], List[str]]:
    def fn(obj: Dict) -> List[str]:
        val = (obj.get("metadata", {}).get("labels") or {}).get(label)
        return [val] if val else []
    return fn


class Lister:
    """Read access to an informer's cache (the lister analog).

    ``deep_copy=True`` (the default) hands every caller a private copy —
    safe to mutate, paid per read. Hot read-only consumers (the sim
    scheduler scans pods/claims/slices on every scheduling attempt) pass
    ``deep_copy=False`` and receive VIEWS of the live cache objects:
    the ownership rule is that zero-copy reads are
    read-only — a caller that wants to mutate must ``copy.deepcopy`` the
    one object it writes, never the whole listing."""

    def __init__(self, store: Dict[str, Dict], lock: threading.RLock,
                 deep_copy: bool = True):
        self._store = store
        self._lock = lock
        self._deep_copy = deep_copy

    def get(self, name: str, namespace: str = "") -> Optional[Dict]:
        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            obj = self._store.get(key)
            if obj is None:
                return None
            if self._deep_copy:
                return copy.deepcopy(obj)
        SHADOW.record(obj)  # zero-copy hand-out: shadow the view
        return obj

    def list(self) -> List[Dict]:
        with self._lock:
            if self._deep_copy:
                return [copy.deepcopy(o) for o in self._store.values()]
            objs = list(self._store.values())
        if SHADOW.enabled:
            for o in objs:
                SHADOW.record(o)
        return objs


class ShardDispatcher:
    """Per-shard bounded delta FIFOs for partitioned handler dispatch.

    The partitioned informer routes each event's handler invocation to
    the shard of its partition key (crc32, the SAME function as the
    scheduler's AllocationIndex.shard_of, so informer shard i feeds
    exactly index shard i) and a dedicated worker drains each FIFO. One
    slow handler or dirty shard therefore never stalls siblings, and
    per-KEY ordering is preserved because a key's shard never changes.

    Queues are BOUNDED: ``offer`` never blocks the watch thread. A full
    shard (or the ``sched.watch_shard_dispatch`` fault) sheds the
    invocation and reports it through ``on_overflow`` — the consumer
    owns recovery (the scheduler marks the matching index shard dirty
    and schedules a resync), mirroring how the fake apiserver ends a
    too-slow watch with 410.

    ``drain_one`` is the single-step seam: the worker loop is just
    ``while running: drain_one(sid, timeout)``.
    """

    def __init__(self, shards: int, cap: int = 4096,
                 on_overflow: Optional[Callable[[int, str], None]] = None,
                 name: str = "informer"):
        if shards <= 0:
            raise ValueError("shards must be positive")
        self._n = shards
        self._cap = cap
        self._on_overflow = on_overflow
        self._name = name
        self._queues = [collections.deque() for _ in range(shards)]
        self._conds = [threading.Condition() for _ in range(shards)]
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self.overflows = 0

    @staticmethod
    def shard_of(key: str, shards: int) -> int:
        return zlib.crc32(key.encode()) % shards

    def route(self, key: str) -> int:
        return self.shard_of(key, self._n)

    @property
    def shards(self) -> int:
        return self._n

    def depth(self, sid: int) -> int:
        with self._conds[sid]:
            return len(self._queues[sid])

    # -- producer side ------------------------------------------------------

    def offer(self, sid: int, thunk: Callable[[], None]) -> bool:
        """Enqueue; returns False (after notifying on_overflow) when the
        shard FIFO is at its bound or the dispatch fault fires."""
        q = self._queues[sid]
        with self._conds[sid]:
            fired = FAULTS.fires("sched.watch_shard_dispatch")
            if not fired and len(q) < self._cap:
                q.append(thunk)
                self._conds[sid].notify()
                return True
            self.overflows += 1
        _SHARD_OVERFLOWS.inc()
        # Outside the shard condition: the consumer's recovery callback
        # may take its own (index) locks.
        self._shard_overflow(sid, "fault" if fired else "full")
        return False

    def _shard_overflow(self, sid: int, reason: str) -> None:
        """The declared degradation of sched.watch_shard_dispatch: shed
        the delta, hand the shard id to the consumer's recovery hook."""
        log.debug("%s dispatcher shard %d overflow (%s)",
                  self._name, sid, reason)
        if self._on_overflow is not None:
            try:
                self._on_overflow(sid, reason)
            except Exception:  # noqa: BLE001 — recovery hook must not kill the watch
                import traceback
                traceback.print_exc()

    # -- consumer side ------------------------------------------------------

    def drain_one(self, sid: int, timeout: Optional[float] = None) -> bool:
        """Run the shard's next thunk; False if none arrived in time."""
        q = self._queues[sid]
        with self._conds[sid]:
            if not q and timeout:
                self._conds[sid].wait(timeout)
            if not q:
                return False
            thunk = q.popleft()
        try:
            thunk()
        except Exception:  # noqa: BLE001 — a broken handler must not kill the worker
            import traceback
            traceback.print_exc()
        return True

    def flush(self, timeout: float = 30.0) -> bool:
        """Barrier: returns once every thunk offered BEFORE the call has
        run (new offers may land behind the barrier thunks; per-shard
        FIFO order makes the prefix guarantee exact)."""
        events = []
        for sid in range(self._n):
            ev = threading.Event()
            with self._conds[sid]:
                self._queues[sid].append(ev.set)
                self._conds[sid].notify()
            events.append(ev)
        ok = True
        for ev in events:
            ok = ev.wait(timeout) and ok
        return ok

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._stopped.clear()
        self._threads = [
            threading.Thread(target=self._worker, args=(sid,), daemon=True,
                             name=f"{self._name}-shard-{sid}")
            for sid in range(self._n)]
        for t in self._threads:
            t.start()

    def _worker(self, sid: int) -> None:
        while not self._stopped.is_set():
            self.drain_one(sid, timeout=0.2)

    def stop(self) -> None:
        self._stopped.set()
        for sid in range(self._n):
            with self._conds[sid]:
                self._conds[sid].notify_all()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []
        # Drain leftovers single-threaded so a stop() between offer and
        # drain doesn't strand handler work (informer stop is ordered
        # after the watch thread join — no new offers by now).
        for sid in range(self._n):
            while self.drain_one(sid):
                pass


class Informer:
    """Single-resource informer. Handlers run on the watch thread; keep them
    quick and enqueue real work to a WorkQueue (the reference's pattern).

    With ``partitions=N`` handler dispatch is instead routed through a
    ShardDispatcher: events are partitioned by ``partition_key`` (crc32
    of the key, aligned with AllocationIndex.shard_of) onto per-shard
    bounded FIFOs drained by per-shard workers. The CACHE is still
    updated on the watch thread (RV-monotonic, single writer); only the
    handler invocations are partitioned, so per-key handler order is
    preserved while one slow shard no longer stalls the rest."""

    def __init__(self, client: ApiClient, gvr: GVR,
                 namespace: Optional[str] = None,
                 label_selector: Optional[str] = None,
                 field_filter: Optional[Callable[[Dict], bool]] = None,
                 copy_on_read: bool = True,
                 copy_events: bool = True,
                 partitions: int = 0,
                 partition_key: Optional[Callable[[Dict], Optional[str]]] = None,
                 shard_queue_cap: int = 4096,
                 on_shard_overflow: Optional[Callable[[int, str], None]] = None):
        """copy_on_read=False makes the lister (and get_by_index) return
        views of the cache instead of deepcopies — for hot read-only
        consumers; see Lister. copy_events=False skips the per-dispatch
        deepcopy of handler arguments — handlers then share the cached
        object and MUST treat it as read-only.

        partitions=N routes handler dispatch through a ShardDispatcher
        of N shards keyed by ``partition_key(obj)`` (falling back to the
        object's namespace/name key when the extractor returns None), so
        objects of one partition — e.g. claims of one node pool — are
        handled strictly in order on one shard while other shards run
        free. ``on_shard_overflow(shard_id, reason)`` fires when a shard
        FIFO sheds work (bound hit or injected fault) — the consumer
        must treat the shard's derived state as dirty and resync."""
        self._client = client
        self._gvr = gvr
        self._namespace = namespace
        self._selector = label_selector
        self._field_filter = field_filter
        self._copy_on_read = copy_on_read
        self._copy_events = copy_events
        self._partition_key = partition_key
        self._dispatcher: Optional[ShardDispatcher] = None
        if partitions > 0:
            self._dispatcher = ShardDispatcher(
                partitions, cap=shard_queue_cap,
                on_overflow=on_shard_overflow,
                name=f"informer-{gvr.plural}")
        self._store: Dict[str, Dict] = {}
        # Deleted key -> the resourceVersion its deletion was seen at, for
        # the last TOMBSTONE_RETENTION deletions (see _set).
        self._tombstones: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self._lock = threading.RLock()
        self._indexers: Dict[str, Callable[[Dict], List[str]]] = {}
        self._indices: Dict[str, Dict[str, Dict[str, Dict]]] = {}
        self._add_handlers: List[Callable[[Dict], None]] = []
        self._update_handlers: List[Callable[[Dict, Dict], None]] = []
        self._delete_handlers: List[Callable[[Dict], None]] = []
        self._synced = threading.Event()
        self._listed_ok = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.lister = Lister(self._store, self._lock,
                             deep_copy=copy_on_read)

    # -- configuration (before start) ---------------------------------------

    def add_indexer(self, name: str, fn: Callable[[Dict], List[str]]) -> None:
        self._indexers[name] = fn
        self._indices[name] = {}

    def on_add(self, fn: Callable[[Dict], None]) -> None:
        self._add_handlers.append(fn)

    def on_update(self, fn: Callable[[Dict, Dict], None]) -> None:
        self._update_handlers.append(fn)

    def on_delete(self, fn: Callable[[Dict], None]) -> None:
        self._delete_handlers.append(fn)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"informer-{self._gvr.plural}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            # Watch threads are daemons and notice _stop within ~1s (the
            # client's short read timeout); a tight join keeps multi-informer
            # shutdown inside a pod's termination grace period.
            self._thread.join(timeout=2)
        if self._dispatcher is not None:
            # After the watch thread: no producer left, so the
            # dispatcher's final single-threaded drain is complete.
            self._dispatcher.stop()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    # -- cache access -------------------------------------------------------

    def get_by_index(self, index: str, value: str) -> List[Dict]:
        with self._lock:
            objs = self._indices.get(index, {}).get(value, {}).values()
            if self._copy_on_read:
                return [copy.deepcopy(o) for o in objs]
            out = list(objs)
        if SHADOW.enabled:
            for o in out:
                SHADOW.record(o)
        return out

    def list_with_tombstones(self) -> Tuple[List[Dict], Dict[str, int]]:
        """The lister's listing and the deletion tombstones (key -> the
        resourceVersion the deletion was seen at), read under one lock:
        a consumer rebuilding derived state from the listing also learns
        which keys died before it, and so which deltas still queued for
        them are stale."""
        with self._lock:
            return self.lister.list(), dict(self._tombstones)

    def update_cache(self, obj: Dict) -> None:
        """Mutation cache: record our own write so the next read sees it
        even before the watch event lands (daemonset.go mutation cache)."""
        if self._accepts(obj):
            with self._lock:
                self._set(obj)

    # -- internals ----------------------------------------------------------

    def _accepts(self, obj: Dict) -> bool:
        return self._field_filter is None or self._field_filter(obj)

    @staticmethod
    def _rv_int(obj: Dict) -> Optional[int]:
        try:
            return int(obj.get("metadata", {}).get("resourceVersion") or 0)
        except (TypeError, ValueError):
            return None  # opaque RV: ordering unknown, accept the write

    # Deletions remembered against resurrection (see _set): beyond this
    # horizon no write of a state older than the deletion is in flight.
    TOMBSTONE_RETENTION = 4096

    def _set(self, obj: Dict):
        """Store obj; returns the previous object, None (new key), or
        the STALE sentinel when obj carries an OLDER resourceVersion
        than the cache — which happens when a consumer's update_cache
        (mutation-cache write) raced an already-queued watch event for
        an earlier state. Accepting that event would roll the cache (and
        any event-driven index built on it) back in time; per-object RV
        monotonicity is exactly what a real watch stream guarantees.

        The same holds across a deletion: a mutation-cache write of a
        state at or before the resourceVersion the object was seen
        deleted at is STALE too (a worker's write landing after the
        watch delivered the delete would otherwise put the deleted
        object back in the cache, where no later event removes it and a
        rebuild from the lister would read it as live). A recreated
        object carries a newer resourceVersion and is accepted."""
        key = meta_namespace_key(obj)
        old = self._store.get(key)
        new_rv = self._rv_int(obj)
        if old is not None:
            old_rv = self._rv_int(old)
            if (new_rv is not None and old_rv is not None
                    and new_rv < old_rv):
                return STALE
        else:
            dead_rv = self._tombstones.get(key)
            if dead_rv is not None:
                if new_rv is not None and new_rv <= dead_rv:
                    return STALE
                del self._tombstones[key]
        self._store[key] = obj
        self._reindex(key, old, obj)
        return old

    def _remove(self, obj: Dict, dead_rv: Optional[int] = None
                ) -> Optional[Dict]:
        """Drop obj's key; `dead_rv` is the resourceVersion the deletion
        was seen at (default: obj's own, as a DELETED event carries)."""
        key = meta_namespace_key(obj)
        old = self._store.pop(key, None)
        self._reindex(key, old, None)
        if dead_rv is None:
            dead_rv = self._rv_int(obj)
        if dead_rv is not None:
            self._tombstones[key] = dead_rv
            self._tombstones.move_to_end(key)
            while len(self._tombstones) > self.TOMBSTONE_RETENTION:
                self._tombstones.popitem(last=False)
        return old

    def _reindex(self, key: str, old: Optional[Dict], new: Optional[Dict]) -> None:
        for name, fn in self._indexers.items():
            idx = self._indices[name]
            if old is not None:
                for val in fn(old):
                    idx.get(val, {}).pop(key, None)
                    if val in idx and not idx[val]:
                        del idx[val]
            if new is not None:
                for val in fn(new):
                    idx.setdefault(val, {})[key] = new

    def _partition_of(self, args: Tuple) -> str:
        """Partition key for a dispatch: try the extractor newest-arg
        first (update dispatch passes (old, new) — the new object is
        authoritative, but e.g. a deallocated claim may only reveal its
        pool in the OLD one), falling back to the object key so every
        event routes deterministically even without a pool."""
        if self._partition_key is not None:
            for a in reversed(args):
                try:
                    key = self._partition_key(a)
                except Exception:  # noqa: BLE001  # drflow: swallow-ok[extractor bug degrades to name-hash routing, which is correct for any key]
                    key = None
                if key:
                    return key
        return meta_namespace_key(args[-1])

    def _dispatch(self, handlers, *args) -> None:
        if self._dispatcher is not None:
            sid = self._dispatcher.route(self._partition_of(args))
            # Shed-on-overflow is handled inside the dispatcher (the
            # on_shard_overflow hook owns recovery); nothing to do here.
            self._dispatcher.offer(
                sid, lambda: self._dispatch_now(handlers, *args))
            return
        self._dispatch_now(handlers, *args)

    def _dispatch_now(self, handlers, *args) -> None:
        if not self._copy_events and SHADOW.enabled:
            for a in args:
                SHADOW.record(a)
        for h in handlers:
            try:
                # copy_events=False: handlers share the cached object and
                # must treat it as read-only (the scheduler's handlers
                # only derive keys / index entries from it).
                h(*(copy.deepcopy(args) if self._copy_events else args))
            except Exception:  # noqa: BLE001 — a broken handler must not kill the watch
                import traceback
                traceback.print_exc()

    # Relist backoff bounds: quick first retry (a single 410 relist should
    # not stall handlers), capped so a down apiserver is not hammered.
    RELIST_BACKOFF_BASE = 0.2
    RELIST_BACKOFF_MAX = 30.0

    def _run(self) -> None:
        backoff = self.RELIST_BACKOFF_BASE
        while not self._stop.is_set():
            self._listed_ok = False
            try:
                self._list_and_watch()
            except Exception as e:  # noqa: BLE001 — relist on any stream failure
                if self._stop.is_set():
                    return
                # A successful LIST (even if the watch later died, e.g.
                # 410 relist) resets the backoff; consecutive list
                # failures grow it — an apiserver outage must not turn
                # every informer into a tight relist loop.
                if self._listed_ok:
                    backoff = self.RELIST_BACKOFF_BASE
                else:
                    backoff = min(backoff * 2, self.RELIST_BACKOFF_MAX)
                _RELISTS.inc()
                log.debug("informer %s list/watch failed (%s: %s); "
                          "relisting in <=%.1fs", self._gvr.plural,
                          type(e).__name__, e, backoff)
                self._stop.wait(backoff * (0.75 + 0.5 * random.random()))

    def _list_and_watch(self) -> None:
        # list_with_rv + resourceVersion-resumed watch closes the gap in
        # which an event between LIST and WATCH would be lost (clients
        # without RV support return "" and watch from 'now').
        objs, list_rv = self._client.list_with_rv(
            self._gvr, namespace=self._namespace,
            label_selector=self._selector)
        self._listed_ok = True
        with self._lock:
            seen = set()
            stale = set()
            for obj in objs:
                if not self._accepts(obj):
                    continue
                key = meta_namespace_key(obj)
                seen.add(key)
                if self._set(obj) is STALE:
                    stale.add(key)  # mutation-cache write outran the LIST
            # Gone at the listing: deleted at or before the list's RV.
            dead_rv = self._rv_int({"metadata": {"resourceVersion": list_rv}})
            for key in [k for k in self._store if k not in seen]:
                gone = self._store[key]
                self._remove(gone, dead_rv=dead_rv)
                self._dispatch(self._delete_handlers, gone)
        for obj in objs:
            if self._accepts(obj) and meta_namespace_key(obj) not in stale:
                self._dispatch(self._add_handlers, obj)
        if self._dispatcher is not None:
            # Consumers treat wait_for_sync() as "every initial add has
            # been HANDLED" (the scheduler's allocation index is built at
            # sync) — with partitioned dispatch that needs a barrier over
            # the shard FIFOs, not just the enqueue loop above.
            self._dispatcher.flush()
        self._synced.set()

        for event_type, obj in self._client.watch(
                self._gvr, namespace=self._namespace,
                label_selector=self._selector,
                resource_version=list_rv or None, stop=self._stop):
            if self._stop.is_set():
                return
            if event_type == "ERROR":
                # Checked before the field filter: the ERROR payload is a
                # Status (no metadata), which any filter would reject. 410
                # Gone or any server-side stream error: raise so _run
                # relists instead of continuing on a stream with a hole.
                raise RuntimeError(f"watch stream error: {obj}")
            if event_type == "BOOKMARK":
                # Resume-progress marker, not an object event: the
                # retrying client has already advanced its resume RV
                # from it; nothing to cache or dispatch.
                continue
            if not self._accepts(obj):
                continue
            if event_type in ("ADDED", "MODIFIED"):
                with self._lock:
                    old = self._set(obj)
                if old is STALE:
                    # An update_cache write already advanced this key
                    # past the event's RV; dispatching the older state
                    # would roll event-driven consumers back in time.
                    continue
                if old is None:
                    self._dispatch(self._add_handlers, obj)
                else:
                    self._dispatch(self._update_handlers, old, obj)
            elif event_type == "DELETED":
                with self._lock:
                    self._remove(obj)
                self._dispatch(self._delete_handlers, obj)
