"""Admission chain for the simcluster: calls registered validating
webhooks the way the real apiserver does (counterpart of
tpu_dra/simcluster/admission.py).

On create/update of a matching resource, builds an AdmissionReview, POSTs
it to the webhook Service's endpoint, and denies the request if the
response says so — honoring per-webhook failurePolicy (the chart ships
Ignore, so installs don't deadlock before the webhook pod is up).

Endpoint resolution: NodeSim acts as the endpoints controller — when a
pod backing a Service starts, it annotates the Service with
`sim/endpoint` (scheme + the pod's REMAPPED port). TLS uses the chart's
render-time self-signed cert; the caller pins the caBundle from the
webhook configuration when present, exactly like the apiserver.
"""

from __future__ import annotations

import base64
import json
import logging
import ssl
import tempfile
import urllib.request
from typing import Dict, Optional

from tpu_dra_torch.k8s.client import GVR
from tpu_dra_torch.k8s.fake import FakeCluster
from tpu_dra_torch.k8s.resources import SERVICES, VALIDATINGWEBHOOKCONFIGURATIONS

log = logging.getLogger("simcluster.admission")

ENDPOINT_ANNOTATION = "sim/endpoint"


class WebhookCaller:
    """admission_hook callable for FakeApiServer."""

    def __init__(self, cluster: FakeCluster, timeout: float = 5.0):
        self._cluster = cluster
        self._timeout = timeout

    def __call__(self, gvr: GVR, obj: Dict,
                 operation: str) -> Optional[str]:
        for vwc in self._cluster.list(VALIDATINGWEBHOOKCONFIGURATIONS):
            for wh in vwc.get("webhooks") or []:
                if not self._rules_match(wh.get("rules") or [], gvr,
                                         operation):
                    continue
                outcome = self._call_webhook(wh, gvr, obj, operation)
                if outcome is None:
                    continue
                kind_, msg = outcome
                name = wh.get("name", "webhook")
                # Real apiserver message formats, so clients (and the e2e
                # suite) see identical text against kind or sim — and an
                # infra failure is NOT misreported as a policy denial.
                if kind_ == "deny":
                    return (f'admission webhook "{name}" denied the '
                            f'request: {msg}')
                return f'failed calling webhook "{name}": {msg}'
        return None

    @staticmethod
    def _rules_match(rules, gvr: GVR, operation: str) -> bool:
        for rule in rules:
            groups = rule.get("apiGroups") or []
            resources = rule.get("resources") or []
            ops = rule.get("operations") or []
            if (gvr.group in groups or "*" in groups) \
                    and (gvr.plural in resources or "*" in resources) \
                    and (operation in ops or "*" in ops):
                return True
        return False

    def _call_webhook(self, wh: Dict, gvr: GVR, obj: Dict,
                      operation: str):
        """Returns None (allowed), ('deny', msg) for a policy denial, or
        ('error', msg) for an infra failure under failurePolicy Fail."""
        fail_policy = wh.get("failurePolicy", "Fail")
        cc = wh.get("clientConfig") or {}
        endpoint = self._resolve_endpoint(cc)
        if endpoint is None:
            if fail_policy == "Ignore":
                return None
            return ("error", "webhook endpoint unavailable")
        # The reviewed version is the version the CLIENT submitted (the
        # real API server admits at request version, not storage
        # version): a v1beta1-shaped claim must reach the webhook as
        # v1beta1 so its conversion path runs.
        obj_api = obj.get("apiVersion", "")
        version = obj_api.split("/", 1)[1] if "/" in obj_api \
            else gvr.version
        review = {
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {
                "uid": obj.get("metadata", {}).get("uid", "sim-admission"),
                "resource": {"group": gvr.group, "version": version,
                             "resource": gvr.plural},
                "kind": {"kind": obj.get("kind", "")},
                "operation": operation,
                "object": obj,
            },
        }
        # URL-based configs carry their own path; only service-based ones
        # append clientConfig.service.path to the resolved endpoint.
        if cc.get("url"):
            url = endpoint
        else:
            url = endpoint + (cc.get("service") or {}).get("path", "/")
        try:
            ctx = self._tls_context(cc)
            req = urllib.request.Request(
                url, json.dumps(review).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self._timeout,
                                        context=ctx) as resp:
                out = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — network/TLS failure
            log.warning("webhook call %s failed: %s", url, e)
            if fail_policy == "Ignore":
                return None
            return ("error", str(e))
        response = out.get("response") or {}
        if response.get("allowed"):
            return None
        return ("deny",
                (response.get("status") or {}).get("message", "denied"))

    def _resolve_endpoint(self, client_config: Dict) -> Optional[str]:
        if client_config.get("url"):
            return client_config["url"]  # full URL, path included
        svc = client_config.get("service") or {}
        try:
            service = self._cluster.get(SERVICES, svc.get("name", ""),
                                        svc.get("namespace"))
        except Exception as e:  # noqa: BLE001
            # An unreachable webhook silently skipped is a policy hole:
            # the failurePolicy decides the outcome, but the lookup
            # failure itself must be visible.
            log.warning("webhook service %s/%s lookup failed: %s",
                        svc.get("namespace"), svc.get("name"), e)
            return None
        return (service["metadata"].get("annotations") or {}).get(
            ENDPOINT_ANNOTATION)

    @staticmethod
    def _tls_context(client_config: Dict) -> ssl.SSLContext:
        ca = client_config.get("caBundle")
        if ca:
            # Pin the configured CA exactly like the apiserver; hostname
            # verification is off because the sim dials 127.0.0.1, not the
            # service DNS name the cert carries.
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            with tempfile.NamedTemporaryFile("w", suffix=".pem") as f:
                f.write(base64.b64decode(ca).decode())
                f.flush()
                ctx.load_verify_locations(f.name)
            return ctx
        ctx = ssl._create_unverified_context()  # noqa: S323
        return ctx
