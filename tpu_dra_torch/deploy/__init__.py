"""Deployment manifests (counterpart of tpu_dra/deploy and the
reference's chart under deployments/helm).

The chart under ``chart/gpu-dra-driver`` is the one source of what a
cluster operator installs: the CRD, DeviceClasses with CEL selectors,
the controller Deployment, the kubelet-plugin DaemonSet, the webhook and
its TLS (selfsigned, cert-manager or secret), the NetworkPolicies, a
ValidatingAdmissionPolicy and RBAC, with the reference's value surface
and render-time validation. ``helmlite`` renders it, ``manifests`` wraps
that render (``all_manifests()``), ``demos`` holds the quickstart
demos, and ``python -m tpu_dra_torch.deploy.render [--set k=v ...]``
prints the render as YAML (and writes the demos).
"""
