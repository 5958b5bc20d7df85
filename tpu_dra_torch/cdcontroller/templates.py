"""Object builders for per-CD stamped resources (counterpart of
tpu_dra/cdcontroller/templates.py): the daemon DaemonSet, the daemon
ResourceClaimTemplate and the user-facing workload ResourceClaimTemplate,
as dict builders of the shapes NVIDIA's compute-domain controller renders
from its YAML templates.
"""

from __future__ import annotations

from typing import Dict, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.k8s.resources import new_object_meta, owner_reference

# Stable name prefix for per-CD objects; suffixed with the CD name.
DAEMON_PREFIX = "gpu-cd-daemon"


def cd_labels(cd_uid: str) -> Dict[str, str]:
    return {apitypes.COMPUTE_DOMAIN_LABEL_KEY: cd_uid}


def daemon_object_name(cd: Dict) -> str:
    return f"{DAEMON_PREFIX}-{cd['metadata']['name']}"


def daemon_daemonset(cd: Dict, *, namespace: str, image: str,
                     daemon_claim_template: str, log_verbosity: int = 0,
                     feature_gates: str = "",
                     max_nodes_per_clique_domain: int = 64,
                     service_account: str = "") -> Dict:
    """Per-CD DaemonSet. nodeSelector is the CD label, so daemon pods appear
    only as the CD kubelet plugin labels nodes (the workload-following
    behavior)."""
    uid = cd["metadata"]["uid"]
    name = daemon_object_name(cd)
    labels = cd_labels(uid)
    pod_labels = dict(labels, **{"app.kubernetes.io/name": DAEMON_PREFIX})
    # The daemon updates CD status from inside its pod; deployed with a
    # dedicated service account it runs under that rather than the
    # namespace default.
    sa_field = ({"serviceAccountName": service_account}
                if service_account else {})
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": new_object_meta(name, namespace, labels=labels,
                                    owner=None),
        "spec": {
            "selector": {"matchLabels": pod_labels},
            "template": {
                "metadata": {"labels": pod_labels},
                "spec": {
                    **sa_field,
                    "nodeSelector": cd_labels(uid),
                    "tolerations": [
                        {"key": "node-role.kubernetes.io/control-plane",
                         "operator": "Exists", "effect": "NoSchedule"},
                    ],
                    "hostNetwork": True,
                    "containers": [{
                        "name": "domain-daemon",
                        "image": image,
                        "command": ["python", "-m",
                                    "tpu_dra_torch.cddaemon.main", "run"],
                        "env": [
                            {"name": "CD_UID", "value": uid},
                            {"name": "CD_NAME",
                             "value": cd["metadata"]["name"]},
                            {"name": "CD_NAMESPACE",
                             "value": cd["metadata"].get("namespace", "")},
                            {"name": "NODE_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "spec.nodeName"}}},
                            {"name": "POD_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "metadata.name"}}},
                            {"name": "POD_IP", "valueFrom": {"fieldRef": {
                                "fieldPath": "status.podIP"}}},
                            {"name": "LOG_VERBOSITY",
                             "value": str(log_verbosity)},
                            {"name": "FEATURE_GATES", "value": feature_gates},
                            {"name": "MAX_NODES_PER_CLIQUE_DOMAIN",
                             "value": str(max_nodes_per_clique_domain)},
                        ],
                        "startupProbe": {
                            "exec": {"command": [
                                "python", "-m",
                                "tpu_dra_torch.cddaemon.main", "check"]},
                            "periodSeconds": 2,
                            "failureThreshold": 60,
                        },
                        "livenessProbe": {
                            "exec": {"command": [
                                "python", "-m",
                                "tpu_dra_torch.cddaemon.main", "check"]},
                            "periodSeconds": 10,
                            "failureThreshold": 3,
                        },
                        "resources": {"claims": [{"name": "cd-daemon"}]},
                    }],
                    "resourceClaims": [{
                        "name": "cd-daemon",
                        "resourceClaimTemplateName": daemon_claim_template,
                    }],
                },
            },
        },
    }


def daemon_claim_template(cd: Dict, *, namespace: str) -> Dict:
    """RCT for the daemon pods' own claim (device class `compute-domain-
    daemon.gpu.dev`, opaque ComputeDomainDaemonConfig{domainID})."""
    uid = cd["metadata"]["uid"]
    cfg = apitypes.ComputeDomainDaemonConfig(domain_id=uid)
    return {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "ResourceClaimTemplate",
        "metadata": new_object_meta(daemon_object_name(cd), namespace,
                                    labels=cd_labels(uid)),
        "spec": {"spec": {"devices": {
            "requests": [{
                "name": "daemon",
                "exactly": {"deviceClassName": apitypes.DEVICE_CLASS_DAEMON},
            }],
            "config": [{
                "requests": ["daemon"],
                "opaque": {
                    "driver": apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
                    "parameters": cfg.to_dict(),
                },
            }],
        }}},
    }


def workload_claim_template(cd: Dict) -> Dict:
    """The user-facing RCT, created in the CD's namespace under the name the
    user chose in spec.channel.resourceClaimTemplate.name. Owned by the CD
    so cascade deletion works even if the controller dies mid-teardown."""
    uid = cd["metadata"]["uid"]
    spec = cd.get("spec", {})
    channel = spec.get("channel") or {}
    name = (channel.get("resourceClaimTemplate") or {}).get("name", "")
    cfg = apitypes.ComputeDomainChannelConfig(
        domain_id=uid,
        allocation_mode=channel.get("allocationMode",
                                    apitypes.ALLOCATION_MODE_SINGLE))
    return {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "ResourceClaimTemplate",
        "metadata": new_object_meta(
            name, cd["metadata"].get("namespace", "default"),
            labels=cd_labels(uid),
            owner=owner_reference({
                "apiVersion": apitypes.API_VERSION,
                "kind": apitypes.COMPUTE_DOMAIN_KIND,
                "metadata": cd["metadata"]})),
        "spec": {"spec": {"devices": {
            "requests": [{
                "name": "channel",
                "exactly": {"deviceClassName": apitypes.DEVICE_CLASS_CHANNEL},
            }],
            "config": [{
                "requests": ["channel"],
                "opaque": {
                    "driver": apitypes.COMPUTE_DOMAIN_DRIVER_NAME,
                    "parameters": cfg.to_dict(),
                },
            }],
        }}},
    }
