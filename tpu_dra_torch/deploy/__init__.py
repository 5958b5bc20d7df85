"""Deployment manifests (counterpart of tpu_dra/deploy).

Manifest builders for everything a cluster operator installs: the CRD,
DeviceClasses with CEL selectors, the controller Deployment, the
kubelet-plugin DaemonSet, the webhook, a ValidatingAdmissionPolicy, and
RBAC (``manifests``); the quickstart demos (``demos``); ``helmlite``,
which renders the chart under ``chart/gpu-dra-driver`` to the same
documents; and ``python -m tpu_dra_torch.deploy.render``, which writes
the manifests and demos as YAML.
"""
