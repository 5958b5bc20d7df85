"""Well-known GVR coordinates + object helpers (counterpart of
tpu_dra/k8s/resources.py, cut to the kinds the kubelet plugin reads
and writes: ResourceClaims, ResourceSlices and Nodes)."""

from __future__ import annotations

import datetime
from typing import Dict, Optional

from tpu_dra_torch.k8s.client import GVR

NODES = GVR("", "v1", "nodes", namespaced=False)
RESOURCECLAIMS = GVR("resource.k8s.io", "v1", "resourceclaims")
RESOURCESLICES = GVR("resource.k8s.io", "v1", "resourceslices", namespaced=False)


def new_object_meta(name: str, namespace: Optional[str] = None,
                    labels: Optional[Dict[str, str]] = None,
                    annotations: Optional[Dict[str, str]] = None) -> Dict:
    meta: Dict = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    return meta


def now_rfc3339() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
