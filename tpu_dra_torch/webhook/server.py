"""Admission review handling + HTTPS server (counterpart of
tpu_dra/webhook/server.py).

Routes ``/validate-resource-claim-parameters`` and ``/readyz``; extracts
the device spec of a ResourceClaim or ResourceClaimTemplate at
resource.k8s.io v1/v1beta1/v1beta2 and converts it to v1; strict-decodes,
normalizes and validates every opaque config owned by this driver (the
GPU driver's GpuConfig, MigDeviceConfig and PassthroughConfig, and the
compute-domain driver's channel and daemon configs); configs of other
drivers pass through.

The handler is transport-independent (AdmissionHandler.review(dict) ->
dict) so it unit-tests without TLS; WebhookServer wraps it in an
http.server with optional TLS for in-cluster deployment.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.api import scheme as apischeme
from tpu_dra_torch.api import types as apitypes

log = logging.getLogger("tpu_dra_torch.webhook")

VALIDATE_PATH = "/validate-resource-claim-parameters"
READYZ_PATH = "/readyz"

# API versions of resource.k8s.io the webhook accepts.
SUPPORTED_VERSIONS = ("v1", "v1beta1", "v1beta2")
OWNED_DRIVERS = (apitypes.GPU_DRIVER_NAME,
                 apitypes.COMPUTE_DOMAIN_DRIVER_NAME)

# v1beta1 DeviceRequest fields that moved under the `exactly` wrapper when
# v1beta2 introduced prioritized-list requests (the one structural break in
# the resource.k8s.io version history; v1beta2 and v1 share the v1 shape).
_V1BETA1_REQUEST_FIELDS = ("deviceClassName", "selectors", "allocationMode",
                           "count", "adminAccess", "tolerations",
                           "capacity")


class ConversionError(ValueError):
    pass


def convert_device_spec_to_v1(devices: Dict, version: str) -> Dict:
    """Field-by-field conversion of a DeviceClaim ('spec.devices') to the
    v1 shape (the scheme.Convert analog). v1beta2 is
    already the v1 shape; v1beta1 requests are flat and must be lifted
    into the `exactly` wrapper."""
    if version not in SUPPORTED_VERSIONS:
        raise ConversionError(f"unsupported resource version {version!r}")
    out = json.loads(json.dumps(devices))  # deep copy; input untouched
    if version in ("v1", "v1beta2"):
        return out
    requests = out.get("requests") or []
    converted = []
    for i, req in enumerate(requests):
        if not isinstance(req, dict):
            raise ConversionError(f"requests[{i}] must be an object")
        if "exactly" in req:
            # v1beta2/v1 syntax inside a v1beta1 object: the API server
            # would have rejected it; refuse rather than guess.
            raise ConversionError(
                f"requests[{i}]: 'exactly' is not a v1beta1 field")
        if "firstAvailable" in req:
            # DRAPrioritizedList added firstAvailable to v1beta1 too
            # (k8s 1.33), and subrequests are flat in every version —
            # already the v1 shape, pass through.
            converted.append(req)
            continue
        exactly = {k: req[k] for k in _V1BETA1_REQUEST_FIELDS if k in req}
        rest = {k: v for k, v in req.items()
                if k not in _V1BETA1_REQUEST_FIELDS}
        converted.append({**rest, "exactly": exactly})
    if requests:
        out["requests"] = converted
    return out


class AdmissionHandler:
    """Pure request->response admission logic."""

    def review(self, admission_review: Dict) -> Dict:
        request = admission_review.get("request") or {}
        uid = request.get("uid", "")
        allowed, message = self._validate_request(request)
        response: Dict = {"uid": uid, "allowed": allowed}
        if not allowed:
            response["status"] = {"message": message, "code": 422}
        return {
            "apiVersion": admission_review.get(
                "apiVersion", "admission.k8s.io/v1"),
            "kind": "AdmissionReview",
            "response": response,
        }

    # -- internals ----------------------------------------------------------

    def _validate_request(self, request: Dict) -> Tuple[bool, str]:
        obj = request.get("object")
        if obj is None:
            return False, "no object in admission request"
        group, version, kind = self._gvk(request, obj)
        if group != "resource.k8s.io":
            return True, ""
        if version not in SUPPORTED_VERSIONS:
            # Unknown future version: admit — the strict node-side decode
            # still guards prepare (fail-open on version skew).
            return True, ""
        try:
            device_specs = [convert_device_spec_to_v1(d, version)
                            for d in self._device_specs(kind, obj)]
        except ValueError as e:
            return False, str(e)
        errors: List[str] = []
        for spec in device_specs:
            errors.extend(self._validate_device_spec(spec))
        if errors:
            return False, "; ".join(errors)
        return True, ""

    def _gvk(self, request: Dict, obj: Dict) -> Tuple[str, str, str]:
        res = request.get("resource") or {}
        group = res.get("group")
        version = res.get("version")
        kind = (request.get("kind") or {}).get("kind") or obj.get("kind", "")
        if group is None or version is None:
            api_version = obj.get("apiVersion", "")
            group, _, version = api_version.partition("/")
        return group, version, kind

    def _device_specs(self, kind: str, obj: Dict) -> List[Dict]:
        """Extract the DeviceClaim ('spec.devices') objects from a claim or
        template; version conversion to v1 happens in
        convert_device_spec_to_v1."""
        if kind == "ResourceClaim":
            spec = obj.get("spec") or {}
        elif kind == "ResourceClaimTemplate":
            spec = ((obj.get("spec") or {}).get("spec") or {})
        else:
            return []
        devices = spec.get("devices") or {}
        if not isinstance(devices, dict):
            raise ValueError("spec.devices must be an object")
        return [devices]

    def _validate_device_spec(self, devices: Dict) -> List[str]:
        errors = []
        # Request names in v1 shape: plain names plus `req/sub` for
        # prioritized-list subrequests. Only meaningful AFTER conversion —
        # v1beta1's flat requests carry the same names, so the lift keeps
        # this check version-uniform.
        names = set()
        for req in devices.get("requests") or []:
            n = (req or {}).get("name")
            if not n:
                continue
            names.add(n)
            for sub in (req.get("firstAvailable") or []):
                if (sub or {}).get("name"):
                    names.add(f"{n}/{sub['name']}")
        for i, entry in enumerate(devices.get("config") or []):
            opaque = (entry or {}).get("opaque") or {}
            driver = opaque.get("driver", "")
            if driver not in OWNED_DRIVERS:
                continue  # not ours: admit
            for r in (entry or {}).get("requests") or []:
                if r not in names:
                    errors.append(
                        f"config[{i}]: targets unknown request {r!r}")
            params = opaque.get("parameters")
            if params is None:
                errors.append(f"config[{i}]: missing opaque parameters")
                continue
            try:
                cfg = apischeme.StrictDecoder.decode(params)
                cfg.normalize()
                cfg.validate()
            except (apischeme.DecodeError, apitypes.ValidationError) as e:
                errors.append(f"config[{i}]: {e}")
        return errors


class WebhookServer:
    """HTTPS (or plain HTTP for tests) server hosting the handler."""

    def __init__(self, handler: Optional[AdmissionHandler] = None,
                 addr: str = "0.0.0.0", port: int = 8443,  # noqa: S104
                 cert_file: Optional[str] = None,
                 key_file: Optional[str] = None):
        self._handler = handler or AdmissionHandler()
        outer = self

        class _Req(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug(fmt, *args)

            def do_GET(self):
                if self.path == READYZ_PATH:
                    self._respond(200, b"ok", "text/plain")
                else:
                    self._respond(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != VALIDATE_PATH:
                    self._respond(404, b"not found", "text/plain")
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    review = json.loads(self.rfile.read(length))
                    out = outer._handler.review(review)
                except Exception as e:  # noqa: BLE001 — malformed request
                    self._respond(400, str(e).encode(), "text/plain")
                    return
                self._respond(200, json.dumps(out).encode(),
                              "application/json")

            def _respond(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        if cert_file and key_file:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_file, key_file)

            class _TLSReq(_Req):
                """Handshake in the worker thread's setup(), NOT on the
                listening socket or in get_request (both run on the accept
                loop): one stalled client (port scanner, plain-TCP health
                check) must not block all admission traffic."""

                def setup(self):
                    self.request.settimeout(10.0)
                    try:
                        self.request = ctx.wrap_socket(self.request,
                                                       server_side=True)
                    except (ssl.SSLError, OSError) as e:
                        # Non-TLS probe or stalled client: drop quietly
                        # instead of a per-connection stderr traceback.
                        log.debug("TLS handshake failed: %s", e)
                        self._handshake_failed = True
                    super().setup()

                def handle(self):
                    if getattr(self, "_handshake_failed", False):
                        return
                    super().handle()

            self._server = ThreadingHTTPServer((addr, port), _TLSReq)
        else:
            self._server = ThreadingHTTPServer((addr, port), _Req)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="webhook")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
