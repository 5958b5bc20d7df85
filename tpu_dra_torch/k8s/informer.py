"""List+watch informer with indexers and a mutation cache (counterpart
of tpu_dra/k8s/informer.py).

``Informer`` keeps a cache of one resource from a LIST followed by a
resourceVersion-resumed WATCH (relisting, with backoff, when the stream
ends in an error such as 410 Gone), runs add/update/delete handlers,
and indexes the cache (``uid_index``, ``label_index``); ``update_cache``
is the mutation cache through which a controller sees its own writes
before their watch events land. Every read and every handler gets its
own copy of the cached object.

Not copied: the zero-copy reads and event dispatch with their view
shadow, and the partitioned dispatch (``ShardDispatcher``): only the
simulated cluster's scheduler uses them.
"""

from __future__ import annotations

import copy
import logging
import random
import threading
from typing import Callable, Dict, List, Optional

from tpu_dra_torch.infra.metrics import DefaultRegistry as _METRICS
from tpu_dra_torch.k8s.client import ApiClient, GVR

log = logging.getLogger("tpu_dra_torch.informer")

# Stream failures are invisible by design (the loop relists), which is
# exactly why they must be counted: a flapping apiserver shows up here
# long before anything user-visible degrades.
_RELISTS = _METRICS.counter(
    "tpu_dra_informer_relists_total",
    "informer list/watch stream failures that forced a relist")

# Sentinel returned by Informer._set for writes that lost an RV race
# (see _set); watch loops skip dispatch for them.
STALE = object()


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
    """Read access to an informer's cache (the lister analog); every read
    is a private copy, safe to mutate."""

    def __init__(self, store: Dict[str, Dict], lock: threading.RLock):
        self._store = store
        self._lock = lock

    def get(self, name: str, namespace: str = "") -> Optional[Dict]:
        key = f"{namespace}/{name}" if namespace else name
        with self._lock:
            obj = self._store.get(key)
            return None if obj is None else copy.deepcopy(obj)

    def list(self) -> List[Dict]:
        with self._lock:
            return [copy.deepcopy(o) for o in self._store.values()]


class Informer:
    """Single-resource informer. Handlers run on the watch thread; keep them
    quick and enqueue real work to a WorkQueue (the reference's pattern).
    Each handler call gets its own copy of the objects."""

    def __init__(self, client: ApiClient, gvr: GVR,
                 namespace: Optional[str] = None,
                 label_selector: Optional[str] = None,
                 field_filter: Optional[Callable[[Dict], bool]] = None):
        self._client = client
        self._gvr = gvr
        self._namespace = namespace
        self._selector = label_selector
        self._field_filter = field_filter
        self._store: Dict[str, Dict] = {}
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
        self.lister = Lister(self._store, self._lock)

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

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    # -- cache access -------------------------------------------------------

    def get_by_index(self, index: str, value: str) -> List[Dict]:
        with self._lock:
            objs = self._indices.get(index, {}).get(value, {}).values()
            return [copy.deepcopy(o) for o in objs]

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

    def _set(self, obj: Dict):
        """Store obj; returns the previous object, None (new key), or
        the STALE sentinel when obj carries an OLDER resourceVersion
        than the cache — which happens when a consumer's update_cache
        (mutation-cache write) raced an already-queued watch event for
        an earlier state. Accepting that event would roll the cache (and
        any event-driven index built on it) back in time; per-object RV
        monotonicity is exactly what a real watch stream guarantees."""
        key = meta_namespace_key(obj)
        old = self._store.get(key)
        if old is not None:
            new_rv, old_rv = self._rv_int(obj), self._rv_int(old)
            if (new_rv is not None and old_rv is not None
                    and new_rv < old_rv):
                return STALE
        self._store[key] = obj
        self._reindex(key, old, obj)
        return old

    def _remove(self, obj: Dict) -> Optional[Dict]:
        key = meta_namespace_key(obj)
        old = self._store.pop(key, None)
        self._reindex(key, old, None)
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

    def _dispatch(self, handlers, *args) -> None:
        for h in handlers:
            try:
                h(*copy.deepcopy(args))
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
            for key in [k for k in self._store if k not in seen]:
                gone = self._store[key]
                self._remove(gone)
                self._dispatch(self._delete_handlers, gone)
        for obj in objs:
            if self._accepts(obj) and meta_namespace_key(obj) not in stale:
                self._dispatch(self._add_handlers, obj)
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
