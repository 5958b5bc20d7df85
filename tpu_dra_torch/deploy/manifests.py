"""Cluster manifests for the GPU DRA driver (counterpart of
tpu_dra/deploy/manifests.py): the chart under ``chart/gpu-dra-driver``
rendered through ``helmlite``. The chart is their one source: the sim
cluster, ``python -m tpu_dra_torch.simcluster --install``, the e2e
runner and ``chip_smoke.py`` all install what it renders.

- DeviceClasses ``gpu.dev`` (a whole GPU), ``mig.gpu.dev`` (a MIG
  device) and the compute-domain daemon and channel classes, each
  selector with the driver clause first;
- RBAC, the compute-domain controller Deployment and the kubelet-plugin
  DaemonSet (``python -m tpu_dra_torch.gpuplugin.main`` and
  ``.cdplugin.main`` on every node labeled ``gpu.dev/present``);
- the webhook (Deployment, Service, its TLS, the
  ValidatingWebhookConfiguration), the NetworkPolicies and the
  ValidatingAdmissionPolicy that refuses unknown opaque config kinds.

Rendering needs PyYAML (the chart's files are YAML).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

APP = "gpu-dra-driver"
CHART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chart", APP)
DEFAULT_NAMESPACE = "gpu-dra-driver"
# The chart's default image: image.repository and, for an empty
# image.tag, the chart's appVersion (Chart.yaml).
DEFAULT_IMAGE = "gpu-dra-driver:0.1.0"
# The node label the plugin DaemonSet selects.
NODE_LABEL = "gpu.dev/present"
DEVICE_CLASS_GPU = "gpu.dev"
DEVICE_CLASS_MIG = "mig.gpu.dev"
WEBHOOK_TLS_SECRET = f"{APP}-webhook-tls"

# Applied first, as helm installs them: the objects others live in or
# are typed by.
_FIRST = ("Namespace", "CustomResourceDefinition")


def render(values: Optional[Dict] = None, ns: str = DEFAULT_NAMESPACE,
           release: str = APP) -> List[Dict]:
    """The chart's documents under `values` (deep-merged over
    values.yaml), namespaces and CRDs first. Raises helmlite's
    TemplateError where the chart's validation refuses the values."""
    from tpu_dra_torch.deploy.helmlite import render_chart

    docs = render_chart(CHART_DIR, values, release_name=release,
                        namespace=ns)
    return sorted(docs, key=lambda d: (
        _FIRST.index(d["kind"]) if d["kind"] in _FIRST else len(_FIRST)))


def all_manifests(ns: str = DEFAULT_NAMESPACE,
                  image: Optional[str] = None,
                  ca_bundle: str = "") -> List[Dict]:
    """The chart's default render in namespace `ns`, with the overrides
    the arguments imply: `image` ("repository:tag") and, with a
    `ca_bundle`, the webhook in ``secret`` TLS mode on the
    WEBHOOK_TLS_SECRET Secret an operator provides with that CA. Without
    one the chart makes its own self-signed cert and Secret."""
    values: Dict = {}
    if image:
        repo, _, tag = image.rpartition(":")
        values["image"] = {"repository": repo, "tag": tag}
    if ca_bundle:
        values["webhook"] = {"tls": {"mode": "secret", "secret": {
            "name": WEBHOOK_TLS_SECRET, "caBundle": ca_bundle}}}
    return render(values, ns)
