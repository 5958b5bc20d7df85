"""Kind <-> GVR mapping for manifest handling (counterpart of
tpu_dra/simcluster/gvk.py): the installer and the sims apply and get
objects by kind; the fake API server stores them by GVR. The table must
agree with ``k8s.fakeserver.KNOWN_GVRS``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from tpu_dra_torch.api.types import GROUP, VERSION
from tpu_dra_torch.k8s.client import GVR

# kind -> (group, plural, namespaced)
_KINDS: Dict[str, Tuple[str, str, bool]] = {
    "Namespace": ("", "namespaces", False),
    "Node": ("", "nodes", False),
    "Pod": ("", "pods", True),
    "Secret": ("", "secrets", True),
    "Service": ("", "services", True),
    "ServiceAccount": ("", "serviceaccounts", True),
    "Event": ("", "events", True),
    "DaemonSet": ("apps", "daemonsets", True),
    "Deployment": ("apps", "deployments", True),
    "ResourceClaim": ("resource.k8s.io", "resourceclaims", True),
    "ResourceClaimTemplate": ("resource.k8s.io", "resourceclaimtemplates",
                              True),
    "ResourceSlice": ("resource.k8s.io", "resourceslices", False),
    "DeviceClass": ("resource.k8s.io", "deviceclasses", False),
    "ComputeDomain": (GROUP, "computedomains", True),
    "CustomResourceDefinition": ("apiextensions.k8s.io",
                                 "customresourcedefinitions", False),
    "ClusterRole": ("rbac.authorization.k8s.io", "clusterroles", False),
    "ClusterRoleBinding": ("rbac.authorization.k8s.io",
                           "clusterrolebindings", False),
    "NetworkPolicy": ("networking.k8s.io", "networkpolicies", True),
    "ValidatingWebhookConfiguration": (
        "admissionregistration.k8s.io", "validatingwebhookconfigurations",
        False),
    "ValidatingAdmissionPolicy": (
        "admissionregistration.k8s.io", "validatingadmissionpolicies",
        False),
    "ValidatingAdmissionPolicyBinding": (
        "admissionregistration.k8s.io",
        "validatingadmissionpolicybindings", False),
}

# kubectl-style aliases (lowercase) -> kind
ALIASES: Dict[str, str] = {}
for kind, (_, plural, _ns) in _KINDS.items():
    ALIASES[kind.lower()] = kind
    ALIASES[plural] = kind
    ALIASES[plural.rstrip("s")] = kind
ALIASES.update({
    "po": "Pod", "ds": "DaemonSet", "deploy": "Deployment",
    "ns": "Namespace", "no": "Node", "svc": "Service", "sa": "ServiceAccount",
    "cd": "ComputeDomain", "crd": "CustomResourceDefinition",
    "rc": "ResourceClaim", "rct": "ResourceClaimTemplate",
    "rs": "ResourceSlice", "dc": "DeviceClass",
})


def gvr_for_kind(kind: str) -> GVR:
    if kind not in _KINDS:
        raise KeyError(f"unknown kind {kind!r}")
    group, plural, namespaced = _KINDS[kind]
    version = {GROUP: VERSION, "resource.k8s.io": "v1"}.get(group, "v1")
    return GVR(group, version, plural, namespaced=namespaced)


def gvr_for_doc(doc: Dict) -> GVR:
    return gvr_for_kind(doc.get("kind", ""))


def resolve_kind(name: str) -> Optional[str]:
    return ALIASES.get(name.lower())
