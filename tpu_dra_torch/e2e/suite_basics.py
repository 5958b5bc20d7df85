"""Basics (tests/e2e/test_basics.sh): the chart installed, the driver's
components up, the inventory published."""

from __future__ import annotations

from typing import Dict

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.e2e.helpers import E2E, check
from tpu_dra_torch.k8s.resources import CRDS, DEVICECLASSES, RESOURCESLICES

CRD_NAME = f"computedomains.{apitypes.GROUP}"
DEVICE_CLASSES = (manifests.DEVICE_CLASS_GPU, manifests.DEVICE_CLASS_MIG,
                  apitypes.DEVICE_CLASS_DAEMON, apitypes.DEVICE_CLASS_CHANNEL)


def run(e2e: E2E) -> Dict:
    check(e2e.get(CRDS, CRD_NAME), f"ComputeDomain CRD {CRD_NAME} missing")
    for dc in DEVICE_CLASSES:
        check(e2e.get(DEVICECLASSES, dc), f"DeviceClass {dc} missing")
    e2e.wait_until(120, "driver pods Ready", e2e.driver_pods_ready)

    def slices():
        drivers = {(s["spec"]["nodeName"], s["spec"]["driver"])
                   for s in e2e.api.list(RESOURCESLICES)}
        return all((n, d) in drivers for n in e2e.cluster.nodes
                   for d in (apitypes.GPU_DRIVER_NAME,
                             apitypes.COMPUTE_DOMAIN_DRIVER_NAME))

    e2e.wait_until(60, "resource slices of both drivers on every node",
                   slices)
    return {"driver_pods": sorted(p["metadata"]["name"]
                                  for p in e2e.pods(e2e.ns)),
            "gpus": {n: sum(1 for d in e2e.gpu_slice_devices(n)
                            if d["attributes"]["type"]["string"] == "gpu")
                     for n in sorted(e2e.cluster.nodes)}}
