"""Kubernetes REST client over stdlib HTTP (counterpart of
tpu_dra/k8s/client.py).

Objects are plain dicts ("unstructured"). Supports CRUD with the status
subresource, JSON merge-patch, list with label selectors (and the
collection's resourceVersion), and the streaming watch (chunked JSON
lines) with a single-term field selector, with in-cluster
service-account config discovery. ``RetryingApiClient`` wraps any
ApiClient (HTTP or fake) with jittered-backoff retry on transient errors
and a watch that reconnects, resuming from the last seen
resourceVersion.
"""

from __future__ import annotations

import json
import os
import random
import socket
import ssl
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, Generator, List, Optional, Tuple

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


def parse_field_selector(selector: str) -> Tuple[Tuple[str, ...], str]:
    """Parse a single-term equality field selector ('spec.nodeName=n5',
    'metadata.name=x') into ((path, segments...), value). Only one
    ``path=value`` term is supported — exactly the shape the node-scoped
    consumers (kubelet pod watches, nodesim) use, and the shape the fake
    apiserver can index watch registration by. Anything else (set
    operators, conjunctions) raises ValueError loudly rather than
    silently matching everything."""
    if not selector or "=" not in selector or "!=" in selector \
            or "," in selector:
        raise ValueError(f"unsupported field selector {selector!r}: only "
                         "a single 'path=value' equality term is indexed")
    path, _, value = selector.partition("=")
    path = path.strip()
    if not path or not value:
        raise ValueError(f"unsupported field selector {selector!r}")
    return tuple(path.split(".")), value.strip()


def field_path_value(obj: Dict, path: Tuple[str, ...]) -> Optional[str]:
    """The object's value at a dotted field path, as a string, or None
    when absent/non-scalar. Shared by the fake apiserver's emit-side
    topic extraction and client-side field filtering so both sides of a
    field-selector watch agree on what a field 'is'."""
    cur = obj
    for seg in path:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(seg)
        if cur is None:
            return None
    if isinstance(cur, (dict, list)):
        return None
    return cur if isinstance(cur, str) else str(cur)


def field_selector_matches(selector: Optional[str], obj: Dict) -> bool:
    if not selector:
        return True
    path, want = parse_field_selector(selector)
    return field_path_value(obj, path) == want


class ApiClient:
    """Abstract client surface shared by HttpApiClient and FakeCluster."""

    def get(self, gvr: GVR, name: str, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def list(self, gvr: GVR, namespace: Optional[str] = None,
             label_selector: Optional[str] = None) -> List[Dict]:
        raise NotImplementedError

    def list_with_rv(self, gvr: GVR, namespace: Optional[str] = None,
                     label_selector: Optional[str] = None
                     ) -> Tuple[List[Dict], str]:
        """(items, collection resourceVersion). Default: no RV — watch then
        starts from 'now' (pre-RV behavior)."""
        return self.list(gvr, namespace, label_selector), ""

    def create(self, gvr: GVR, obj: Dict, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def update(self, gvr: GVR, obj: Dict, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def update_status(self, gvr: GVR, obj: Dict, namespace: Optional[str] = None) -> Dict:
        raise NotImplementedError

    def patch(self, gvr: GVR, name: str, patch: Dict,
              namespace: Optional[str] = None) -> Dict:
        """JSON merge-patch (RFC 7386)."""
        raise NotImplementedError

    def delete(self, gvr: GVR, name: str, namespace: Optional[str] = None) -> None:
        raise NotImplementedError

    def watch(self, gvr: GVR, namespace: Optional[str] = None,
              label_selector: Optional[str] = None,
              resource_version: Optional[str] = None,
              stop: Optional[threading.Event] = None,
              field_selector: Optional[str] = None,
              ) -> Generator[Tuple[str, Dict], None, None]:
        """Yield (event_type, object): ADDED/MODIFIED/DELETED/BOOKMARK.

        ``field_selector`` is a single equality term ('spec.nodeName=n5');
        servers that index watch registration by field (the fake) use it
        to skip fan-out entirely for non-matching events."""
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

    def update_status(self, gvr, obj, namespace=None):
        meta = obj.get("metadata", {})
        ns = namespace or meta.get("namespace")
        return self._request("PUT", gvr.path(ns, meta["name"], "status"), body=obj)

    def patch(self, gvr, name, patch, namespace=None):
        return self._request("PATCH", gvr.path(namespace, name), body=patch,
                             content_type="application/merge-patch+json")

    def delete(self, gvr, name, namespace=None):
        try:
            self._request("DELETE", gvr.path(namespace, name))
        except NotFoundError:
            pass

    def list_with_rv(self, gvr, namespace=None, label_selector=None):
        """(items, resourceVersion) — the List response's collection RV, for
        gap-free list+watch resumption."""
        query = {}
        if label_selector:
            query["labelSelector"] = label_selector
        out = self._request("GET", gvr.path(namespace), query=query or None)
        rv = (out.get("metadata") or {}).get("resourceVersion", "")
        return out.get("items", []), rv

    def watch(self, gvr, namespace=None, label_selector=None,
              resource_version=None, stop=None, field_selector=None):
        """Streaming watch over a raw socket with our own HTTP/chunked
        parser: connection establishment uses the full client timeout; the
        stream is read with a 1s socket timeout so `stop` is noticed
        promptly, and because ALL partial data lives in our own buffer a
        timed-out read can never desync the chunked framing (which it can
        inside http.client's buffered decoder)."""
        query = {"watch": "true", "allowWatchBookmarks": "true"}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        if resource_version:
            query["resourceVersion"] = resource_version
        parsed = urllib.parse.urlsplit(self._base)
        path = gvr.path(namespace) + "?" + urllib.parse.urlencode(query)
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        sock = socket.create_connection((parsed.hostname, port),
                                        timeout=self._timeout)
        try:
            if parsed.scheme == "https" and self._ssl is not None:
                sock = self._ssl.wrap_socket(
                    sock, server_hostname=parsed.hostname)
            auth = (f"Authorization: Bearer {self._token}\r\n"
                    if self._token else "")
            sock.sendall(
                f"GET {path} HTTP/1.1\r\n"
                f"Host: {parsed.hostname}:{port}\r\n"
                f"Accept: application/json\r\n{auth}"
                f"Connection: close\r\n\r\n".encode())

            buf = b""
            # Headers arrive within the establishment timeout.
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ApiError(0, "watch connection closed during headers")
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            status_line = head.split(b"\r\n", 1)[0].decode()
            status = int(status_line.split()[1])
            if status != 200:
                raise ApiError(status, f"watch failed: {status_line}")
            chunked = b"transfer-encoding: chunked" in head.lower()

            sock.settimeout(1.0)
            line_buf = b""  # de-chunked JSON-lines payload

            def feed(data: bytes):
                nonlocal line_buf
                line_buf += data

            chunk_state = {"need": None}  # bytes left in current chunk

            def dechunk():
                """Consume complete chunked frames from buf into line_buf."""
                nonlocal buf
                while True:
                    if chunk_state["need"] is None:
                        if b"\r\n" not in buf:
                            return
                        size_line, _, rest = buf.partition(b"\r\n")
                        try:
                            size = int(size_line.split(b";")[0].strip()
                                       or b"0", 16)
                        except ValueError:
                            raise ApiError(0, "bad chunk framing")
                        buf = rest
                        if size == 0:
                            chunk_state["need"] = -1  # EOF marker
                            return
                        chunk_state["need"] = size
                    elif chunk_state["need"] == -1:
                        return
                    else:
                        need = chunk_state["need"]
                        if len(buf) < need + 2:  # data + trailing CRLF
                            return
                        feed(buf[:need])
                        buf = buf[need + 2:]
                        chunk_state["need"] = None

            while stop is None or not stop.is_set():
                if chunked:
                    dechunk()
                else:
                    feed(buf)
                    buf = b""
                while b"\n" in line_buf:
                    line, _, line_buf = line_buf.partition(b"\n")
                    if not line.strip():
                        continue
                    evt = json.loads(line)
                    yield evt.get("type", ""), evt.get("object", {})
                if chunk_state["need"] == -1:
                    return  # server ended the stream
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    return
                buf += data
        finally:
            sock.close()


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


class _WatchDropped(Exception):
    """Internal: the watch stream died mid-flight; reconnect from the
    last seen resourceVersion."""


class RetryingApiClient(ApiClient):
    """Decorates any ApiClient with the reliability layer every reconcile
    loop needs (the client-go rest retry + reflector resume analog):

    - every verb retries transient errors (TRANSIENT_STATUSES, socket
      errors) with jittered exponential backoff, up to `max_attempts`;
    - ``watch`` reconnects on stream death, resuming from the last seen
      object resourceVersion so no events are lost across the gap. A
      server-side ERROR event (410 Gone above all) is passed through and
      ends the stream: resuming past it would hide a history hole, so
      the informer must relist (informer.py treats ERROR as fatal).
      Resume requires an RV to resume FROM: if the stream dies before
      any RV is known (none passed, none delivered), the wrapper ends
      the stream instead of silently reconnecting from "now" — a
      from-now reconnect would swallow whatever happened during the
      outage with no signal to the consumer.

    Mutating verbs are retried too: an ambiguous first attempt (request
    landed, response lost) then surfaces as AlreadyExists/Conflict on
    the retry — exactly what reconcile callers already tolerate.

    Consults fault sites ``k8s.api.request`` (per attempt, inside the
    retry loop) and ``k8s.watch.drop`` (per delivered event), so chaos
    schedules exercise this exact code path rather than a test double.
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

    def list_with_rv(self, gvr, namespace=None, label_selector=None):
        return self._call("list", self._inner.list_with_rv, gvr, namespace,
                          label_selector)

    def create(self, gvr, obj, namespace=None):
        return self._call("create", self._inner.create, gvr, obj, namespace)

    def update(self, gvr, obj, namespace=None):
        return self._call("update", self._inner.update, gvr, obj, namespace)

    def update_status(self, gvr, obj, namespace=None):
        return self._call("update", self._inner.update_status, gvr, obj,
                          namespace)

    def patch(self, gvr, name, patch, namespace=None):
        return self._call("patch", self._inner.patch, gvr, name, patch,
                          namespace)

    def delete(self, gvr, name, namespace=None):
        return self._call("delete", self._inner.delete, gvr, name, namespace)

    # -- watch --------------------------------------------------------------

    def watch(self, gvr, namespace=None, label_selector=None,
              resource_version=None, stop=None, field_selector=None):
        rv = resource_version
        failures = 0
        while stop is None or not stop.is_set():
            gen = None
            try:
                FAULTS.check("k8s.api.request", verb="watch")
                gen = self._inner.watch(
                    gvr, namespace=namespace, label_selector=label_selector,
                    resource_version=rv, stop=stop,
                    field_selector=field_selector)
                for event_type, obj in gen:
                    if FAULTS.fires("k8s.watch.drop"):
                        raise _WatchDropped()
                    if event_type == "ERROR":
                        # 410 Gone (or any server stream error): resuming
                        # from rv would skip the trimmed gap. Surface it;
                        # the informer relists.
                        yield event_type, obj
                        return
                    failures = 0
                    new_rv = (obj.get("metadata") or {}).get(
                        "resourceVersion")
                    if new_rv:
                        rv = new_rv
                    yield event_type, obj
                # Clean server close (idle timeout): reconnect from the
                # last seen RV — the entire point of this wrapper.
            except Exception as e:  # noqa: BLE001 — classified below
                if not isinstance(e, _WatchDropped) and not is_transient(e):
                    raise
            finally:
                if gen is not None:
                    gen.close()
            if rv is None:
                # Nothing to resume from: reconnecting would start at
                # "now" and hide the gap. End the stream; the consumer's
                # relist path (the pre-wrapper contract) takes over.
                return
            failures += 1
            delay = self._backoff(min(failures - 1, self._max_attempts - 1))
            if stop is not None:
                stop.wait(delay)  # shutdown must not ride out the backoff
            else:
                self._sleep(delay)
