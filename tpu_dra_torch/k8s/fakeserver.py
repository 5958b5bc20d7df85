"""HTTP fake Kubernetes API server: FakeCluster behind real REST
(counterpart of tpu_dra/k8s/fakeserver.py).

The sim cluster runs the driver's binaries (``python -m
tpu_dra_torch.*.main``) as separate processes against a real API server
endpoint. This serves a FakeCluster over the REST conventions
HttpApiClient and its informers speak:

  GET    /api/v1/... | /apis/<group>/<version>/...      (get/list)
  GET    ...?watch=true                                  (chunked stream)
  POST   collection                                      (create)
  PUT    item [/status]                                  (update)
  PATCH  item (application/merge-patch+json)             (merge patch)
  DELETE item

It is deliberately schema-less (objects are opaque dicts), matching
FakeCluster semantics: resourceVersion bumping, finalizer-aware deletion,
label selectors, namespaced + cluster-scoped resources.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from tpu_dra_torch.k8s import resources
from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiError, ConflictError, GVR, NotFoundError,
)
from tpu_dra_torch.k8s.fake import FakeCluster, _merge_patch

# Registry of resources the server routes (plural -> GVR); mirrors
# tpu_dra_torch.k8s.resources. Unknown plurals 404 like a real apiserver.
KNOWN_GVRS = {
    (g.group, g.version, g.plural): g
    for g in (resources.PODS, resources.NODES, resources.EVENTS,
              resources.DAEMONSETS, resources.DEPLOYMENTS,
              resources.RESOURCECLAIMS, resources.RESOURCECLAIMTEMPLATES,
              resources.RESOURCESLICES, resources.DEVICECLASSES,
              resources.COMPUTEDOMAINS,
              resources.NAMESPACES, resources.SECRETS, resources.SERVICES,
              resources.SERVICEACCOUNTS, resources.CRDS,
              resources.CLUSTERROLES, resources.CLUSTERROLEBINDINGS,
              resources.NETWORKPOLICIES,
              resources.VALIDATINGWEBHOOKCONFIGURATIONS,
              resources.VALIDATINGADMISSIONPOLICIES,
              resources.VALIDATINGADMISSIONPOLICYBINDINGS)
}


def _parse_path(path: str) -> Optional[Tuple[GVR, Optional[str],
                                             Optional[str], Optional[str]]]:
    """Returns (gvr, namespace, name, subresource) or None."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        return None
    if parts[0] == "api":
        if len(parts) < 2:
            return None
        group, rest = "", parts[2:]
        version = parts[1]
    elif parts[0] == "apis":
        if len(parts) < 3:
            return None
        group, version, rest = parts[1], parts[2], parts[3:]
    else:
        return None
    namespace = None
    # namespaces/<ns>/<plural>...: a namespaced path; namespaces/<name>
    # alone is the Namespace object itself.
    if rest and rest[0] == "namespaces" and len(rest) >= 3:
        namespace = rest[1]
        rest = rest[2:]
    if not rest:
        return None
    plural, rest = rest[0], rest[1:]
    gvr = KNOWN_GVRS.get((group, version, plural))
    if gvr is None:
        return None
    name = rest[0] if rest else None
    subresource = rest[1] if len(rest) > 1 else None
    return gvr, namespace, name, subresource


class FakeApiServer:
    """Serves `cluster` (a FakeCluster) over HTTP; `url` is the base URL
    usable as --kube-api-url / KUBE_API_URL."""

    def __init__(self, cluster: Optional[FakeCluster] = None,
                 addr: str = "127.0.0.1", port: int = 0,
                 admission_hook=None):
        """admission_hook(gvr, obj, operation) -> Optional[str]: when set,
        runs before create/update like the real admission chain; a
        returned string denies the request (the simcluster wires a caller
        that POSTs AdmissionReviews to registered webhooks)."""
        self.cluster = cluster or FakeCluster()
        self.admission_hook = admission_hook
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send_json(self, code: int, doc: Dict):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str, reason: str = ""):
                doc = {
                    "kind": "Status", "apiVersion": "v1", "code": code,
                    "status": "Failure", "message": message}
                if reason:
                    doc["reason"] = reason
                self._send_json(code, doc)

            def _api_error(self, e: ApiError):
                # Mirror a real apiserver's Status reason so HTTP clients
                # can distinguish AlreadyExists from update conflicts
                # (client-go errors.IsAlreadyExists analog).
                reason = ""
                if isinstance(e, AlreadyExistsError):
                    reason = "AlreadyExists"
                elif isinstance(e, ConflictError):
                    reason = "Conflict"
                elif isinstance(e, NotFoundError):
                    reason = "NotFound"
                return self._error(e.status, e.message, reason)

            def _body(self) -> Dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length)) if length else {}

            def do_GET(self):  # noqa: N802
                url = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qs(url.query)
                parsed = _parse_path(url.path)
                if parsed is None:
                    return self._error(404, f"unknown path {url.path}")
                gvr, ns, name, _sub = parsed
                try:
                    if name:
                        return self._send_json(
                            200, outer.cluster.get(gvr, name, ns))
                    selector = (query.get("labelSelector") or [None])[0]
                    if (query.get("watch") or ["false"])[0] == "true":
                        rv = (query.get("resourceVersion") or [None])[0]
                        fsel = (query.get("fieldSelector") or [None])[0]
                        return self._watch(gvr, ns, selector, rv, fsel)
                    items, rv = outer.cluster.list_with_rv(
                        gvr, namespace=ns, label_selector=selector)
                    return self._send_json(200, {
                        "kind": "List", "apiVersion": "v1",
                        "metadata": {"resourceVersion": rv},
                        "items": items})
                except NotFoundError as e:
                    return self._error(404, str(e))

            def _watch(self, gvr, ns, selector, resource_version=None,
                       field_selector=None):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                try:
                    for event_type, obj in outer.cluster.watch(
                            gvr, namespace=ns, label_selector=selector,
                            resource_version=resource_version,
                            stop=outer._stop,
                            field_selector=field_selector):
                        line = json.dumps({"type": event_type,
                                           "object": obj}) + "\n"
                        write_chunk(line.encode())
                except (BrokenPipeError, ConnectionResetError):
                    return

            def _admission_denial(self, gvr, obj, operation):
                """Runs the admission chain; returns a denial message or
                None (the shared seam for CREATE/UPDATE/PATCH-as-UPDATE)."""
                if outer.admission_hook is None:
                    return None
                return outer.admission_hook(gvr, obj, operation)

            def _deny(self, message: str):
                # The hook supplies the full apiserver-format message
                # ('admission webhook "<name>" denied the request: ...').
                return self._error(400, message, reason="Invalid")

            def do_POST(self):  # noqa: N802
                parsed = _parse_path(urllib.parse.urlparse(self.path).path)
                if parsed is None:
                    return self._error(404, "unknown path")
                gvr, ns, _name, _sub = parsed
                try:
                    body = self._body()
                    deny = self._admission_denial(gvr, body, "CREATE")
                    if deny:
                        return self._deny(deny)
                    created = outer.cluster.create(gvr, body, namespace=ns)
                    return self._send_json(201, created)
                except ApiError as e:
                    return self._api_error(e)

            def do_PUT(self):  # noqa: N802
                parsed = _parse_path(urllib.parse.urlparse(self.path).path)
                if parsed is None:
                    return self._error(404, "unknown path")
                gvr, ns, _name, sub = parsed
                try:
                    body = self._body()
                    if sub == "status":
                        out = outer.cluster.update_status(gvr, body,
                                                          namespace=ns)
                    else:
                        deny = self._admission_denial(gvr, body, "UPDATE")
                        if deny:
                            return self._deny(deny)
                        out = outer.cluster.update(gvr, body, namespace=ns)
                    return self._send_json(200, out)
                except ApiError as e:
                    return self._api_error(e)

            def do_PATCH(self):  # noqa: N802
                parsed = _parse_path(urllib.parse.urlparse(self.path).path)
                if parsed is None or parsed[2] is None:
                    return self._error(404, "unknown path")
                gvr, ns, name, _sub = parsed
                try:
                    patch = self._body()
                    if outer.admission_hook is not None:
                        # Admission sees the POST-patch object, like the
                        # real apiserver (PATCH is an UPDATE there).
                        # cluster.get already returns a copy.
                        merged = _merge_patch(
                            outer.cluster.get(gvr, name, ns), patch)
                        deny = self._admission_denial(gvr, merged, "UPDATE")
                        if deny:
                            return self._deny(deny)
                    out = outer.cluster.patch(gvr, name, patch,
                                              namespace=ns)
                    return self._send_json(200, out)
                except ApiError as e:
                    return self._api_error(e)

            def do_DELETE(self):  # noqa: N802
                parsed = _parse_path(urllib.parse.urlparse(self.path).path)
                if parsed is None or parsed[2] is None:
                    return self._error(404, "unknown path")
                gvr, ns, name, _sub = parsed
                outer.cluster.delete(gvr, name, ns)
                return self._send_json(200, {"kind": "Status",
                                             "status": "Success"})

        self._stop = threading.Event()
        self._server = ThreadingHTTPServer((addr, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="fake-apiserver")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
