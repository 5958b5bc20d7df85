"""In-memory fake Kubernetes API server (counterpart of
tpu_dra/k8s/fake.py, cut to the verbs the kubelet plugin uses).

Thread-safe object store with resourceVersion bumping, uid and
creationTimestamp stamping, optimistic-concurrency conflicts, test
reactors and ``wait_for``.

Not copied: watch streams with their replay log and field-selector
index, the status subresource, merge-patch, finalizers, generateName and
the Lease helpers. They come with the slices that use them.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, Optional, Tuple

from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ConflictError, GVR, NotFoundError,
    json_deepcopy, label_selector_matches,
)
from tpu_dra_torch.k8s.resources import now_rfc3339


class FakeCluster(ApiClient):
    """Thread-safe in-memory object store implementing the ApiClient surface."""

    def __init__(self):
        self._lock = threading.RLock()
        # uid source: a per-cluster random tag + counter; uniqueness per
        # cluster instance is the whole contract.
        self._uid_tag = os.urandom(4).hex()
        self._uid_seq = itertools.count(1)
        # (gvr.key, namespace or "") -> name -> object
        self._store: Dict[Tuple[str, str], Dict[str, Dict]] = {}
        self._rv = itertools.count(1)
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
        obj.setdefault("metadata", {})["resourceVersion"] = str(next(self._rv))

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
            return json_deepcopy(obj)

    def update(self, gvr, obj, namespace=None):
        with self._lock:
            obj = json_deepcopy(obj)
            obj = self._run_reactors("update", gvr, obj)
            meta = obj.get("metadata", {})
            bucket = self._store.get(self._ns_key(gvr, namespace, obj), {})
            name = meta.get("name", "")
            if name not in bucket:
                raise NotFoundError(f"{gvr.plural}/{name}")
            current = bucket[name]["metadata"]
            want_rv = meta.get("resourceVersion")
            if want_rv and want_rv != current.get("resourceVersion"):
                raise ConflictError(
                    f"{gvr.plural}/{name}: resourceVersion mismatch")
            # Server-side fields survive the update.
            meta["uid"] = current.get("uid")
            meta["creationTimestamp"] = current.get("creationTimestamp")
            self._bump(obj)
            bucket[name] = obj
            return json_deepcopy(obj)

    def delete(self, gvr, name, namespace=None):
        with self._lock:
            self._run_reactors("delete", gvr, None)
            self._store.get(self._ns_key(gvr, namespace), {}).pop(name, None)

    # -- test conveniences --------------------------------------------------

    def wait_for(self, predicate, timeout: float = 5.0, interval: float = 0.02) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(interval)
        return predicate()
