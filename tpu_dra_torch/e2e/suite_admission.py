"""Admission (tests/e2e/test_admission.sh): the validating webhook is in
the request path. An invalid opaque config is refused at apply time once
the webhook is up, a valid one is admitted; a v1beta1 claim (flat
requests) is lifted to `exactly` and validated, v1 syntax inside a
v1beta1 object is refused, and a foreign driver's config passes."""

from __future__ import annotations

from typing import Dict, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.e2e.helpers import E2E, check, namespace
from tpu_dra_torch.k8s.resources import RESOURCECLAIMS
from tpu_dra_torch.k8s.client import ApiError

NS = "adm-e2e"


def claim(name: str, *, version: str = "v1",
          params: Optional[Dict] = None, driver: str = "",
          exactly: bool = True) -> Dict:
    req: Dict = {"name": "gpu"}
    if exactly:
        req["exactly"] = {"deviceClassName": manifests.DEVICE_CLASS_GPU}
    else:
        req["deviceClassName"] = manifests.DEVICE_CLASS_GPU
    params = params if params is not None else {
        "apiVersion": apitypes.API_VERSION,
        "kind": apitypes.GPU_CONFIG_KIND}
    return {"apiVersion": f"resource.k8s.io/{version}",
            "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"devices": {"requests": [req], "config": [{
                "requests": ["gpu"], "opaque": {
                    "driver": driver or apitypes.GPU_DRIVER_NAME,
                    "parameters": params}}]}}}


def bad_params() -> Dict:
    return {"apiVersion": apitypes.API_VERSION,
            "kind": apitypes.GPU_CONFIG_KIND, "bogusField": True}


def create(e2e: E2E, doc: Dict) -> Optional[str]:
    """None when admitted (the claim is deleted again), else the error."""
    try:
        e2e.api.create(RESOURCECLAIMS, doc, namespace=NS)
    except ApiError as err:
        return str(err)
    e2e.delete(RESOURCECLAIMS, doc["metadata"]["name"], NS)
    return None


def run(e2e: E2E) -> Dict:
    e2e.apply([namespace(NS)])

    # failurePolicy is Ignore: refusals start only once the webhook pod
    # is up and its Service has an endpoint.
    def denied():
        err = create(e2e, claim("bad-claim", params=bad_params()))
        return err if err and "denied the request" in err else None

    denial = e2e.wait_until(120, "webhook denies the invalid claim", denied)
    err = create(e2e, claim("good-claim"))
    check(err is None, f"valid claim was rejected: {err}")
    err = create(e2e, claim("beta-good", version="v1beta1", exactly=False,
                            params={"apiVersion": apitypes.API_VERSION,
                                    "kind": apitypes.GPU_CONFIG_KIND,
                                    "sharing": {"strategy":
                                                apitypes.TimeSlicingStrategy}}))
    check(err is None, f"valid v1beta1 claim was rejected: {err}")
    err = create(e2e, claim("beta-bad", version="v1beta1", exactly=False,
                            params=bad_params()))
    check(err and "denied the request" in err,
          f"invalid v1beta1 claim was not denied: {err}")
    err = create(e2e, claim("beta-exactly", version="v1beta1"))
    check(err and "exactly" in err,
          f"a v1beta1 object with 'exactly' was not refused for it: {err}")
    err = create(e2e, claim("foreign-claim", driver="other-vendor.example",
                            params={"anything": "goes"}))
    check(err is None, f"foreign-driver claim was rejected: {err}")
    return {"denial": denial}
