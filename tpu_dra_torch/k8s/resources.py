"""Well-known GVR coordinates + object helpers (counterpart of
tpu_dra/k8s/resources.py, cut to the kinds the port reads and writes:
ResourceClaims, their templates and ResourceSlices; Nodes, Pods and the
Deployments of the per-claim MPS control daemons; the compute-domain
stack's DaemonSets and resource.gpu.dev ComputeDomains; the Lease of the
scheduler's leader election; and the kinds
the deployment manifests carry, so that the fake API server can store a
whole chart install)."""

from __future__ import annotations

import datetime
from typing import Dict, Optional

from tpu_dra_torch.k8s.client import GVR

PODS = GVR("", "v1", "pods")
EVENTS = GVR("", "v1", "events")
NODES = GVR("", "v1", "nodes", namespaced=False)
DAEMONSETS = GVR("apps", "v1", "daemonsets")
DEPLOYMENTS = GVR("apps", "v1", "deployments")
RESOURCECLAIMS = GVR("resource.k8s.io", "v1", "resourceclaims")
RESOURCECLAIMTEMPLATES = GVR("resource.k8s.io", "v1", "resourceclaimtemplates")
RESOURCESLICES = GVR("resource.k8s.io", "v1", "resourceslices", namespaced=False)
DEVICECLASSES = GVR("resource.k8s.io", "v1", "deviceclasses", namespaced=False)

COMPUTEDOMAINS = GVR("resource.gpu.dev", "v1beta1", "computedomains")

# coordination.k8s.io Leases back the HA scheduler's leader election
# (infra/leaderelect.py): the elector CASes holder/renew fields under
# the apiserver's resourceVersion conflict semantics.
LEASES = GVR("coordination.k8s.io", "v1", "leases")

# Kinds the driver itself never reads but the deployment manifests carry.
NAMESPACES = GVR("", "v1", "namespaces", namespaced=False)
SECRETS = GVR("", "v1", "secrets")
SERVICES = GVR("", "v1", "services")
SERVICEACCOUNTS = GVR("", "v1", "serviceaccounts")
CRDS = GVR("apiextensions.k8s.io", "v1", "customresourcedefinitions",
           namespaced=False)
CLUSTERROLES = GVR("rbac.authorization.k8s.io", "v1", "clusterroles",
                   namespaced=False)
CLUSTERROLEBINDINGS = GVR("rbac.authorization.k8s.io", "v1",
                          "clusterrolebindings", namespaced=False)
NETWORKPOLICIES = GVR("networking.k8s.io", "v1", "networkpolicies")
VALIDATINGWEBHOOKCONFIGURATIONS = GVR(
    "admissionregistration.k8s.io", "v1",
    "validatingwebhookconfigurations", namespaced=False)
VALIDATINGADMISSIONPOLICIES = GVR(
    "admissionregistration.k8s.io", "v1",
    "validatingadmissionpolicies", namespaced=False)
VALIDATINGADMISSIONPOLICYBINDINGS = GVR(
    "admissionregistration.k8s.io", "v1",
    "validatingadmissionpolicybindings", namespaced=False)


def new_object_meta(name: str, namespace: Optional[str] = None,
                    labels: Optional[Dict[str, str]] = None,
                    annotations: Optional[Dict[str, str]] = None,
                    owner: Optional[Dict] = None) -> Dict:
    meta: Dict = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    if owner:
        meta["ownerReferences"] = [owner]
    return meta


def owner_reference(obj: Dict, controller: bool = True,
                    block_owner_deletion: bool = True) -> Dict:
    meta = obj["metadata"]
    return {
        "apiVersion": obj.get("apiVersion", ""),
        "kind": obj.get("kind", ""),
        "name": meta["name"],
        "uid": meta.get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": block_owner_deletion,
    }


def now_rfc3339() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
