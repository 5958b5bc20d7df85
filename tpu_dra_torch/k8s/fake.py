"""In-memory fake Kubernetes API server (counterpart of
tpu_dra/k8s/fake.py).

Thread-safe object store with resourceVersion bumping, uid and
creationTimestamp stamping, optimistic-concurrency conflicts, the status subresource, JSON merge-patch, finalizer-aware
deletion, test reactors and ``wait_for``; and watch streams with a
bounded replay log, field-selector indexed registration and bookmark
semantics, so the controllers' informers run against the apiserver's
list+watch contract without a cluster.

The Lease helpers (``lease_micro_time``, ``parse_lease_micro_time``,
``new_lease``) serve the scheduler's leader election
(infra/leaderelect.py): the store's resourceVersion conflict is the
compare half of its compare-and-swap.

Not copied: generateName.
"""

from __future__ import annotations

import datetime
import itertools
import os
import queue
import threading
from typing import Dict, Generator, List, Optional, Tuple

from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ConflictError, GVR, NotFoundError,
    field_path_value, json_deepcopy, label_selector_matches,
    parse_field_selector,
)
from tpu_dra_torch.k8s.resources import now_rfc3339

# A watch registration topic: (gvr_key, field_path|None, field_value|None).
# (gk, None, None) is the broadcast topic every plain watcher sits on;
# field-selector watchers sit on (gk, ("spec","nodeName"), "n5") and the
# emit path only walks the topics an event actually belongs to — a
# node-scoped watcher is never even iterated for another node's events.
_Topic = Tuple[str, Optional[Tuple[str, ...]], Optional[str]]


class _Watcher:
    """One watch stream: a BOUNDED queue of (type, obj) items. The fake
    apiserver never blocks its (lock-holding) emit path on a slow
    consumer — a full queue marks the stream overflowed, remaining
    buffered events drain, then the stream ends with 410 so the consumer
    relists (the real apiserver's too-slow-watcher behavior)."""

    __slots__ = ("gvr_key", "namespace", "selector", "topic", "events",
                 "closed", "overflowed")

    def __init__(self, gvr_key: str, namespace: Optional[str],
                 selector: Optional[str], topic: _Topic, cap: int):
        self.gvr_key = gvr_key
        self.namespace = namespace
        self.selector = selector
        self.topic = topic
        self.events: "queue.Queue[Tuple[str, Dict]]" = queue.Queue(maxsize=cap)
        self.closed = False
        self.overflowed = False

    def offer(self, item: Tuple[str, Dict]) -> bool:
        if self.overflowed:
            return False
        try:
            self.events.put_nowait(item)
            return True
        except queue.Full:
            self.overflowed = True
            return False


class FakeCluster(ApiClient):
    """Thread-safe in-memory object store implementing the ApiClient surface."""

    # Bounded event log for resourceVersion replay (closes the LIST->WATCH
    # gap a real apiserver closes the same way).
    EVENT_LOG_CAP = 4096
    # Per-watcher queue bound: past this, the stream is declared too slow
    # and ended with 410 (drain-then-error) so the consumer relists.
    WATCH_QUEUE_CAP = 4096

    def __init__(self):
        self._lock = threading.RLock()
        # uid source: a per-cluster random tag + counter. uuid.uuid4 was
        # one getrandom syscall per created object — a large slice of
        # fake-apiserver wall at churn scale for randomness nothing
        # needs; uniqueness per cluster instance is the whole contract.
        self._uid_tag = os.urandom(4).hex()
        self._uid_seq = itertools.count(1)
        # (gvr.key, namespace or "") -> name -> object
        self._store: Dict[Tuple[str, str], Dict[str, Dict]] = {}
        self._rv = itertools.count(1)
        self._last_rv = 0
        self._watchers: List[_Watcher] = []
        # topic -> watchers. Emit walks only the topics an event belongs
        # to (broadcast + one per registered field path with a value on
        # the object), so fan-out cost scales with MATCHING watchers, not
        # total watchers — the difference between O(1) and O(10k) per
        # event once every simulated node runs its own scoped watch.
        self._watch_index: Dict[_Topic, List[_Watcher]] = {}
        # gvr_key -> field paths with at least one historical registration
        # (bounded: the schema-level universe of watched paths). Emit
        # extracts these paths once per event to compute its topics.
        self._field_paths: Dict[str, set] = {}
        # (gvr_key, path) -> global _trimmed_rv when the path was FIRST
        # registered. Before that point no per-topic watermarks exist for
        # the path, so a resume from older history must 410 (we cannot
        # prove the trimmed range held no matching events).
        self._field_path_since: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        # [(rv, gvr_key, ns, event_type, obj, topics)] — replayed for
        # watches that resume from an older resourceVersion. Topics are
        # precomputed at emit so trim-time watermark upkeep is a lookup.
        self._events: List[Tuple[int, str, str, str, Dict, List[_Topic]]] = []
        # Highest RV dropped from the bounded log: a resume from at or
        # below it has a hole and must get 410 Gone, not a silent skip —
        # UNLESS the watch is field-scoped and the per-topic watermark
        # below proves no matching event was in the hole (bookmark
        # semantics: dead ranges are skippable when provably irrelevant).
        self._trimmed_rv = 0
        # topic -> highest rv of a trimmed event that carried this topic.
        self._topic_trimmed: Dict[_Topic, int] = {}
        # Hooks for tests: callables (verb, gvr, obj) -> obj|None run before
        # the verb; raising simulates apiserver errors (webhook analog).
        self.reactors = []

    # -- helpers ------------------------------------------------------------

    def _ns_key(self, gvr: GVR, namespace: Optional[str], obj: Optional[Dict] = None
                ) -> Tuple[str, str]:
        ns = ""
        if gvr.namespaced:
            ns = namespace or (obj or {}).get("metadata", {}).get("namespace") or "default"
        return (gvr.key, ns)

    def _bump(self, obj: Dict) -> None:
        self._last_rv = next(self._rv)
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._last_rv)

    def _emit(self, gvr: GVR, ns: str, event_type: str, obj: Dict) -> None:
        # ONE frozen snapshot per event (single-encode), shared by the
        # replay log and every watcher queue (multi-enqueue) — events are
        # read-only by contract; the informer layer copies before handing
        # objects to mutating consumers. Fan-out walks the topic index,
        # not the watcher list: the broadcast topic plus one topic per
        # registered field path the object has a value at. 10k node-scoped
        # watchers cost this loop exactly one queue append (the one
        # matching node), not 10k filter evaluations.
        snapshot = json_deepcopy(obj)
        rv = int(obj.get("metadata", {}).get("resourceVersion", "0") or 0)
        gk = gvr.key
        topics: List[_Topic] = [(gk, None, None)]
        for path in self._field_paths.get(gk, ()):
            val = field_path_value(snapshot, path)
            if val is not None:
                topics.append((gk, path, val))
        self._events.append((rv, gk, ns, event_type, snapshot, topics))
        if len(self._events) > self.EVENT_LOG_CAP:
            cut = len(self._events) - self.EVENT_LOG_CAP
            self._trimmed_rv = max(self._trimmed_rv, self._events[cut - 1][0])
            for ev in self._events[:cut]:
                for t in ev[5]:
                    if t[1] is not None and ev[0] > self._topic_trimmed.get(t, 0):
                        self._topic_trimmed[t] = ev[0]
            del self._events[:cut]
        labels = snapshot.get("metadata", {}).get("labels", {}) or {}
        item = (event_type, snapshot)
        for t in topics:
            for w in self._watch_index.get(t, ()):
                if w.closed:
                    continue
                if w.namespace and gvr.namespaced and w.namespace != ns:
                    continue
                if w.selector and not label_selector_matches(w.selector, labels):
                    continue
                w.offer(item)

    def _run_reactors(self, verb: str, gvr: GVR, obj: Optional[Dict]):
        for r in self.reactors:
            out = r(verb, gvr, obj)
            if out is not None:
                obj = out
        return obj

    # -- verbs --------------------------------------------------------------

    def get(self, gvr, name, namespace=None):
        with self._lock:
            objs = self._store.get(self._ns_key(gvr, namespace), {})
            if name not in objs:
                raise NotFoundError(f"{gvr.plural}/{name}")
            return json_deepcopy(objs[name])

    def list(self, gvr, namespace=None, label_selector=None):
        with self._lock:
            if gvr.namespaced and namespace is None:
                buckets = [v for (k, _ns), v in self._store.items() if k == gvr.key]
            else:
                buckets = [self._store.get(self._ns_key(gvr, namespace), {})]
            out = []
            for bucket in buckets:
                for obj in bucket.values():
                    labels = obj.get("metadata", {}).get("labels", {}) or {}
                    if label_selector_matches(label_selector, labels):
                        out.append(json_deepcopy(obj))
            out.sort(key=lambda o: (o["metadata"].get("namespace", ""),
                                    o["metadata"]["name"]))
            return out

    def create(self, gvr, obj, namespace=None):
        with self._lock:
            obj = json_deepcopy(obj)
            obj = self._run_reactors("create", gvr, obj)
            meta = obj.setdefault("metadata", {})
            key = self._ns_key(gvr, namespace, obj)
            if gvr.namespaced:
                meta.setdefault("namespace", key[1])
            bucket = self._store.setdefault(key, {})
            if meta["name"] in bucket:
                raise AlreadyExistsError(f"{gvr.plural}/{meta['name']}")
            meta.setdefault(
                "uid", f"uid-{self._uid_tag}-{next(self._uid_seq)}")
            meta.setdefault("creationTimestamp", now_rfc3339())
            self._bump(obj)
            bucket[meta["name"]] = obj
            self._emit(gvr, key[1], "ADDED", obj)
            return json_deepcopy(obj)

    def _update_impl(self, gvr, obj, namespace, subresource: Optional[str]):
        with self._lock:
            obj = json_deepcopy(obj)
            obj = self._run_reactors("update", gvr, obj)
            meta = obj.get("metadata", {})
            key = self._ns_key(gvr, namespace, obj)
            bucket = self._store.get(key, {})
            name = meta.get("name", "")
            if name not in bucket:
                raise NotFoundError(f"{gvr.plural}/{name}")
            current = bucket[name]
            want_rv = meta.get("resourceVersion")
            if want_rv and want_rv != current["metadata"].get("resourceVersion"):
                raise ConflictError(
                    f"{gvr.plural}/{name}: resourceVersion mismatch")
            if subresource == "status":
                merged = json_deepcopy(current)
                merged["status"] = json_deepcopy(obj.get("status"))
                # Kubernetes permits metadata (labels/annotations)
                # changes through the status subresource — the
                # scheduler stamps the claim's traceparent annotation
                # in the SAME write as the allocation, so
                # the fake must not silently strip it.
                for mkey in ("labels", "annotations"):
                    if mkey in meta:
                        merged["metadata"][mkey] = json_deepcopy(
                            meta[mkey])
            else:
                merged = obj
                # status subresource: spec-updates do not touch status
                if "status" in current and gvr.key in _STATUS_SUBRESOURCE:
                    merged["status"] = json_deepcopy(current["status"])
                # preserve immutable server-side fields
                merged["metadata"]["uid"] = current["metadata"].get("uid")
                merged["metadata"].setdefault(
                    "creationTimestamp", current["metadata"].get("creationTimestamp"))
                if "deletionTimestamp" in current["metadata"]:
                    merged["metadata"]["deletionTimestamp"] = \
                        current["metadata"]["deletionTimestamp"]
            self._bump(merged)
            bucket[name] = merged
            self._emit(gvr, key[1], "MODIFIED", merged)
            # Finalizer-aware GC: a deleting object whose finalizers emptied
            # out is removed (apiserver behavior the CD teardown relies on).
            if (merged["metadata"].get("deletionTimestamp")
                    and not merged["metadata"].get("finalizers")):
                del bucket[name]
                # Fresh RV for the DELETED event: reusing the MODIFIED
                # event's RV would let a watch resuming from it skip the
                # deletion entirely (`rv <= since` in the replay path) —
                # an event-loss hole an incremental cache index never
                # recovers from without a full resync.
                self._bump(merged)
                self._emit(gvr, key[1], "DELETED", merged)
            return json_deepcopy(merged)

    def update(self, gvr, obj, namespace=None):
        return self._update_impl(gvr, obj, namespace, None)

    def update_status(self, gvr, obj, namespace=None):
        return self._update_impl(gvr, obj, namespace, "status")

    def patch(self, gvr, name, patch, namespace=None):
        with self._lock:
            current = self.get(gvr, name, namespace)
            merged = _merge_patch(current, patch)
            merged["metadata"]["name"] = name
            return self._update_impl(gvr, merged, namespace, None)

    def delete(self, gvr, name, namespace=None):
        with self._lock:
            self._run_reactors("delete", gvr, None)
            key = self._ns_key(gvr, namespace)
            bucket = self._store.get(key, {})
            if name not in bucket:
                return
            obj = bucket[name]
            finalizers = obj.get("metadata", {}).get("finalizers") or []
            if finalizers:
                if not obj["metadata"].get("deletionTimestamp"):
                    obj["metadata"]["deletionTimestamp"] = now_rfc3339()
                    self._bump(obj)
                    self._emit(gvr, key[1], "MODIFIED", obj)
                return
            del bucket[name]
            # Deletion advances the RV so a replay from the pre-delete list
            # RV includes this DELETED event.
            self._bump(obj)
            self._emit(gvr, key[1], "DELETED", obj)

    def list_with_rv(self, gvr, namespace=None, label_selector=None):
        with self._lock:
            return (self.list(gvr, namespace, label_selector),
                    str(self._last_rv))

    @staticmethod
    def _gone_status(message: str) -> Tuple[str, Dict]:
        return ("ERROR", {
            "kind": "Status", "apiVersion": "v1", "status": "Failure",
            "code": 410, "reason": "Expired", "message": message})

    def watch(self, gvr, namespace=None, label_selector=None,
              resource_version=None, stop=None, field_selector=None,
              ) -> Generator[Tuple[str, Dict], None, None]:
        """Watch with indexed registration and bookmark semantics.

        A ``field_selector`` ('spec.nodeName=n5') registers the watcher
        on a single topic: the emit path never iterates it for events
        whose object has a different value at that path. This suits
        set-once fields (a pod's nodeName binds once, kubelet-style):
        an object CREATED without the field only hits the broadcast
        topic, the MODIFIED that sets it and every later event reach the
        scoped watcher, and no DELETED is synthesized on a field-value
        transition away — scoped consumers of mutable fields must use a
        broadcast watch and filter client-side.

        Resume (``resource_version``) replays retained history after
        that RV. A broadcast resume below the trim point gets 410 Gone;
        a field-scoped resume additionally consults the per-topic trim
        watermark, so it survives log compaction as long as no MATCHING
        event was trimmed — dead ranges full of other nodes' churn are
        skipped, not relisted. Field-scoped streams open with a BOOKMARK
        carrying the current RV so the client's resume point advances
        past dead history even when no real event matches.
        """
        gk = gvr.key
        ns_scope = namespace if gvr.namespaced else None
        field = None
        if field_selector:
            field = parse_field_selector(field_selector)
        topic: _Topic = (gk, field[0], field[1]) if field else (gk, None, None)
        gone: Optional[str] = None
        w = _Watcher(gk, ns_scope, label_selector, topic,
                     self.WATCH_QUEUE_CAP)
        with self._lock:
            if field:
                # Register the path for emit-side topic extraction. The
                # watermark floor is the trim point at FIRST registration:
                # older history never had this topic indexed.
                self._field_paths.setdefault(gk, set()).add(field[0])
                self._field_path_since.setdefault(
                    (gk, field[0]), self._trimmed_rv)
            # Atomically: replay events after resource_version, then go
            # live — no gap in which an event can be lost.
            if resource_version:
                try:
                    since = int(resource_version)
                except ValueError:
                    since = 0
                if field:
                    dead = max(
                        self._topic_trimmed.get(topic, 0),
                        self._field_path_since[(gk, field[0])])
                else:
                    dead = self._trimmed_rv
                if since < dead:
                    # Events between `since` and the oldest retained (or
                    # provably-relevant) RV are unrecoverable. Real
                    # apiserver semantics: 410 Gone, client relists.
                    gone = (f"too old resource version: "
                            f"{resource_version} ({dead})")
                else:
                    for rv, gvr_key, ns, event_type, obj, _t in self._events:
                        if rv <= since or gvr_key != gk:
                            continue
                        if ns_scope and gvr.namespaced and ns_scope != ns:
                            continue
                        if field and field_path_value(obj, field[0]) != field[1]:
                            continue
                        labels = obj.get("metadata", {}).get("labels", {}) or {}
                        if not label_selector_matches(label_selector, labels):
                            continue
                        # Stored snapshots are frozen (read-only contract)
                        # — replay shares them, same as live fan-out.
                        w.offer((event_type, obj))
            if gone is None:
                self._watchers.append(w)
                self._watch_index.setdefault(topic, []).append(w)
                if field:
                    # Start-of-stream bookmark (field-scoped streams
                    # only — broadcast consumers predate bookmarks and
                    # don't need them): advances the client's resume RV
                    # to "now" so an idle scoped watcher can later
                    # resume across ranges trimmed while it was away.
                    w.offer(("BOOKMARK", {"metadata": {
                        "resourceVersion": str(self._last_rv)}}))
        if gone is not None:
            yield self._gone_status(gone)
            return
        try:
            while stop is None or not stop.is_set():
                try:
                    yield w.events.get(timeout=0.1)
                except queue.Empty:
                    if w.overflowed:
                        # Buffered events all drained; the stream lost
                        # later ones. End it the way the real apiserver
                        # ends a too-slow watch: the client relists.
                        yield self._gone_status(
                            "watch queue overflow: events dropped, relist")
                        return
                    continue
        finally:
            w.closed = True
            with self._lock:
                if w in self._watchers:
                    self._watchers.remove(w)
                peers = self._watch_index.get(topic)
                if peers is not None:
                    try:
                        peers.remove(w)
                    except ValueError:
                        pass
                    if not peers:
                        del self._watch_index[topic]

    # -- test conveniences --------------------------------------------------

    def wait_for(self, predicate, timeout: float = 5.0, interval: float = 0.02) -> bool:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(interval)
        return predicate()


# GVR keys whose status is a separate subresource (spec updates don't
# clobber status): the kinds of the compute-domain stack, whose CRD
# declares the status subresource. Deployments and ResourceClaims keep
# the plain update the MPS node sim and the kubelet plugin's tests write
# their status with.
_STATUS_SUBRESOURCE = {
    "resource.gpu.dev/v1beta1/computedomains",
    "apps/v1/daemonsets",
    "core/v1/pods",
    "core/v1/nodes",
}


# ---------------------------------------------------------------------------
# coordination.k8s.io/v1 Lease (the HA scheduler's leader election)
# ---------------------------------------------------------------------------
# The Lease rides the generic store: what makes it usable for election
# is that _update_impl's resourceVersion conflict gives electors a real
# compare-and-swap — two standbys racing a takeover CAS the same RV and
# exactly one wins. `spec.leaseTransitions` is the fencing generation a
# leader stamps into its claim-status writes (infra/leaderelect.py).

_LEASE_MICRO_FMT = "%Y-%m-%dT%H:%M:%S.%fZ"


def lease_micro_time(t: float) -> str:
    """RFC3339 MicroTime (the real Lease's acquireTime/renewTime type —
    election math needs sub-second precision a 1s timestamp loses)."""
    return datetime.datetime.fromtimestamp(
        t, datetime.timezone.utc).strftime(_LEASE_MICRO_FMT)


def parse_lease_micro_time(s: Optional[str]) -> float:
    """Inverse of lease_micro_time; 0.0 for a missing/garbled stamp (an
    unreadable renewTime reads as expired — safe for takeover, and the
    holder's own next renew rewrites it)."""
    if not s:
        return 0.0
    try:
        return datetime.datetime.strptime(
            s, _LEASE_MICRO_FMT).replace(
                tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        return 0.0


def new_lease(name: str, namespace: str, holder: str,
              lease_duration_s: float, now: float) -> Dict:
    """A coordination.k8s.io/v1 Lease held by `holder` as of `now`."""
    stamp = lease_micro_time(now)
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "holderIdentity": holder,
            "leaseDurationSeconds": lease_duration_s,
            "acquireTime": stamp,
            "renewTime": stamp,
            "leaseTransitions": 1,
        },
    }


def _merge_patch(target: Dict, patch: Dict) -> Dict:
    """RFC 7386 JSON merge-patch."""
    if not isinstance(patch, dict):
        return json_deepcopy(patch)
    out = json_deepcopy(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out
