"""Kubernetes REST client over stdlib HTTP (counterpart of
tpu_dra/k8s/client.py, cut to the verbs the kubelet plugin uses).

Objects are plain dicts ("unstructured"). Supports get, list (with
label selectors), create, update and delete, with in-cluster
service-account config discovery. ``RetryingApiClient`` wraps
any ApiClient (HTTP or fake) with jittered-backoff retry on transient
errors.

Not copied: the status subresource, merge-patch, watch streams (the
reference's chunked-JSON watch and the retrying wrapper's resume), field
selectors and list-with-RV. They come with the slices that use them.
"""

from __future__ import annotations

import json
import os
import random
import ssl
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tpu_dra_torch.infra.faults import FAULTS, FaultInjected


@dataclass(frozen=True)
class GVR:
    """Group/version/resource coordinate; group '' = core."""
    group: str
    version: str
    plural: str
    namespaced: bool = True

    def path(self, namespace: Optional[str] = None, name: Optional[str] = None,
             subresource: Optional[str] = None) -> str:
        base = f"/api/{self.version}" if not self.group else f"/apis/{self.group}/{self.version}"
        parts = [base]
        if self.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(self.plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    @property
    def key(self) -> str:
        return f"{self.group or 'core'}/{self.version}/{self.plural}"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status
        self.message = message


class NotFoundError(ApiError):
    def __init__(self, message: str = "not found"):
        super().__init__(404, message)


class ConflictError(ApiError):
    def __init__(self, message: str = "conflict"):
        super().__init__(409, message)


class AlreadyExistsError(ApiError):
    def __init__(self, message: str = "already exists"):
        super().__init__(409, message)


def parse_label_selector(selector: str) -> List[Tuple[str, Optional[str]]]:
    """Parse 'k=v,k2,k3!=x' into [(key, value|None)] (None = exists).
    '!=' terms are represented as (key, ('!=', value))."""
    terms: List[Tuple[str, Any]] = []
    for part in filter(None, (p.strip() for p in (selector or "").split(","))):
        if "!=" in part:
            k, _, v = part.partition("!=")
            terms.append((k.strip(), ("!=", v.strip())))
        elif "=" in part:
            k, _, v = part.partition("=")
            terms.append((k.strip().rstrip("="), v.strip()))
        else:
            terms.append((part, None))
    return terms


def label_selector_matches(selector: Optional[str], labels: Dict[str, str]) -> bool:
    if not selector:
        return True
    for key, want in parse_label_selector(selector):
        if want is None:
            if key not in labels:
                return False
        elif isinstance(want, tuple):
            if labels.get(key) == want[1]:
                return False
        elif labels.get(key) != want:
            return False
    return True


_intern = sys.intern


def json_deepcopy(obj):
    """Deep copy for JSON-shaped API objects (dict/list containers,
    immutable scalars). copy.deepcopy's generic machinery (memo table,
    reduce protocol) dominated the fake apiserver at churn scale — this
    specialized walk is the same isolation at a fraction of the cost.
    Non-JSON containers (a tuple a test tucked into an object) are
    returned as-is: the API-object contract treats them as values.

    Dict KEYS are interned: API objects repeat the same field names
    ("metadata", "resourceVersion", "attributes", ...) across millions
    of copies at 10k-node churn scale, and interning collapses them to
    shared singletons — less allocation on the emit hot path and
    pointer-fast dict probes downstream. Keys only: the name universe
    is bounded (schema field names), while VALUES (pod names, RVs) grow
    without bound and would bloat the intern table forever."""
    cls = obj.__class__
    if cls is dict:
        return {_intern(k) if k.__class__ is str else k: json_deepcopy(v)
                for k, v in obj.items()}
    if cls is list:
        return [json_deepcopy(v) for v in obj]
    return obj


class ApiClient:
    """Abstract client surface shared by HttpApiClient and FakeCluster."""

    def get(self, gvr: GVR, name: str, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def list(self, gvr: GVR, namespace: Optional[str] = None,
             label_selector: Optional[str] = None) -> List[Dict]:
        raise NotImplementedError

    def create(self, gvr: GVR, obj: Dict, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def update(self, gvr: GVR, obj: Dict, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def delete(self, gvr: GVR, name: str, namespace: Optional[str] = None) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------

IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105
IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
IN_CLUSTER_NS = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"


class HttpApiClient(ApiClient):
    """Stdlib-HTTP client. Config resolution mirrors KubeClientConfig
    (kubeclient.go): explicit base URL flag > in-cluster env
    (KUBERNETES_SERVICE_HOST + service account files)."""

    def __init__(self, base_url: Optional[str] = None,
                 token: Optional[str] = None, ca_file: Optional[str] = None,
                 insecure: bool = False, timeout: float = 30.0):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise ValueError(
                    "no API server URL given and not running in-cluster")
            base_url = f"https://{host}:{port}"
            if token is None and os.path.exists(IN_CLUSTER_TOKEN):
                token = open(IN_CLUSTER_TOKEN).read().strip()
            if ca_file is None and os.path.exists(IN_CLUSTER_CA):
                ca_file = IN_CLUSTER_CA
        self._base = base_url.rstrip("/")
        self._token = token
        self._timeout = timeout
        if self._base.startswith("https"):
            if insecure:
                self._ssl = ssl._create_unverified_context()  # noqa: S323
            else:
                self._ssl = ssl.create_default_context(cafile=ca_file)
        else:
            self._ssl = None

    # -- plumbing -----------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 query: Optional[Dict[str, str]] = None,
                 content_type: str = "application/json") -> Dict:
        url = self._base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout,
                                        context=self._ssl) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            msg = e.read().decode(errors="replace")
            if e.code == 404:
                raise NotFoundError(msg) from e
            if e.code == 409:
                # A real apiserver returns 409 for both optimistic-concurrency
                # conflicts and create-on-existing; distinguish by the Status
                # body's reason (client-go errors.IsAlreadyExists analog) so
                # callers' `except AlreadyExistsError` works over HTTP too.
                # Only the parsed Status reason is trusted: a substring test
                # on the raw body would misclassify a genuine stale-RV
                # Conflict whose object data happens to echo the phrase
                # "already exists".
                reason = ""
                try:
                    reason = json.loads(msg).get("reason", "")
                except (ValueError, AttributeError):
                    pass
                if reason == "AlreadyExists":
                    raise AlreadyExistsError(msg) from e
                raise ConflictError(msg) from e
            raise ApiError(e.code, msg) from e

    # -- verbs --------------------------------------------------------------

    def get(self, gvr, name, namespace=None):
        return self._request("GET", gvr.path(namespace, name))

    def list(self, gvr, namespace=None, label_selector=None):
        query = {}
        if label_selector:
            query["labelSelector"] = label_selector
        out = self._request("GET", gvr.path(namespace), query=query or None)
        return out.get("items", [])

    def create(self, gvr, obj, namespace=None):
        ns = namespace or obj.get("metadata", {}).get("namespace")
        return self._request("POST", gvr.path(ns), body=obj)

    def update(self, gvr, obj, namespace=None):
        meta = obj.get("metadata", {})
        ns = namespace or meta.get("namespace")
        return self._request("PUT", gvr.path(ns, meta["name"]), body=obj)

    def delete(self, gvr, name, namespace=None):
        try:
            self._request("DELETE", gvr.path(namespace, name))
        except NotFoundError:
            pass


# ---------------------------------------------------------------------------
# Resilient client wrapper
# ---------------------------------------------------------------------------

# HTTP statuses a well-behaved client retries (client-go's
# IsRetryableError set: throttling + server-side transient failures).
# Status 0 is our own "connection-level failure" marker.
TRANSIENT_STATUSES = frozenset({0, 429, 500, 502, 503, 504})


def is_transient(err: Exception) -> bool:
    """Would a retry plausibly succeed? Conflict/NotFound/AlreadyExists
    and other 4xx are caller-level outcomes, not network weather."""
    if isinstance(err, (NotFoundError, ConflictError, AlreadyExistsError)):
        return False
    if isinstance(err, FaultInjected):
        return True  # injected faults model transient infrastructure
    if isinstance(err, ApiError):
        return err.status in TRANSIENT_STATUSES
    return isinstance(err, (OSError, TimeoutError))


class RetryingApiClient(ApiClient):
    """Decorates any ApiClient with the retry layer every reconcile loop
    needs: every verb retries transient errors (TRANSIENT_STATUSES,
    socket errors) with jittered exponential backoff, up to
    `max_attempts`.

    Mutating verbs are retried too: an ambiguous first attempt (request
    landed, response lost) then surfaces as AlreadyExists/Conflict on
    the retry — exactly what reconcile callers already tolerate.

    Consults the fault site ``k8s.api.request`` per attempt, inside the
    retry loop.
    """

    def __init__(self, inner: ApiClient, *, max_attempts: int = 5,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 jitter: float = 0.5, rng: Optional[random.Random] = None,
                 sleep=time.sleep):
        self._inner = inner
        self._max_attempts = max_attempts
        self._base = base_delay
        self._max_delay = max_delay
        self._jitter = jitter
        self._rng = rng or random.Random()
        # The batched prepare path fans GETs out from pool threads, so
        # verbs (and their backoff jitter) run concurrently; Random's
        # Mersenne state is not thread-safe, so draws are serialized.
        self._rng_lock = threading.Lock()
        self._sleep = sleep

    @property
    def inner(self) -> ApiClient:
        return self._inner

    def _backoff(self, attempt: int) -> float:
        d = min(self._base * (2 ** attempt), self._max_delay)
        with self._rng_lock:
            u = self._rng.random()
        return max(0.0, d * (1.0 + self._jitter * (u - 0.5)))

    def _call(self, verb: str, fn, *args, **kwargs):
        last: Optional[Exception] = None
        for attempt in range(self._max_attempts):
            try:
                FAULTS.check("k8s.api.request", verb=verb)
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient(e):
                    raise
                last = e
            if attempt < self._max_attempts - 1:
                # No sleep after the final attempt: the outcome is
                # decided, don't tax the error path with a dead wait.
                self._sleep(self._backoff(attempt))
        assert last is not None
        raise last

    # -- verbs --------------------------------------------------------------

    def get(self, gvr, name, namespace=None):
        return self._call("get", self._inner.get, gvr, name, namespace)

    def list(self, gvr, namespace=None, label_selector=None):
        return self._call("list", self._inner.list, gvr, namespace,
                          label_selector)

    def create(self, gvr, obj, namespace=None):
        return self._call("create", self._inner.create, gvr, obj, namespace)

    def update(self, gvr, obj, namespace=None):
        return self._call("update", self._inner.update, gvr, obj, namespace)

    def delete(self, gvr, name, namespace=None):
        return self._call("delete", self._inner.delete, gvr, name, namespace)
