"""Stress (tests/e2e/test_stress.sh): PODS pods churned against one
shared time-sliced claim for LOOPS loops (the reference's sim-mode
scale); each loop's seconds from apply to all Succeeded, and their p95
(the reference's churn_p95_s side metric)."""

from __future__ import annotations

import time
from typing import Dict

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.e2e.helpers import E2E, namespace, pod
from tpu_dra_torch.k8s.resources import PODS

NS = "gpu-stress"
PODS_PER_LOOP = 4
LOOPS = 3
ASSERT_GPU = ["python", "-c",
              "import os; assert os.environ.get('CUDA_VISIBLE_DEVICES'); "
              "print('ok')"]


def shared_claim() -> Dict:
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": "shared", "namespace": NS},
            "spec": {"devices": {
                "requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": manifests.DEVICE_CLASS_GPU}}],
                "config": [{"requests": ["gpu"], "opaque": {
                    "driver": apitypes.GPU_DRIVER_NAME,
                    "parameters": {"apiVersion": apitypes.API_VERSION,
                                   "kind": apitypes.GPU_CONFIG_KIND,
                                   "sharing": {"strategy": apitypes.
                                               TimeSlicingStrategy}}}}]}}}


def p95(values) -> float:
    """The reference's nearest-rank p95 (its awk: v[int(0.95 (n-1)) + 1],
    1-based)."""
    v = sorted(values)
    return v[int(0.95 * (len(v) - 1))]


def run(e2e: E2E) -> Dict:
    e2e.apply([namespace(NS), shared_claim()])
    # The card's time slice cannot be set from its host: a card node
    # leaves the shared claim to the simulated node.
    node = e2e.fake_node if e2e.card_node else None
    loop_s = []
    for loop in range(LOOPS):
        t0 = time.monotonic()
        e2e.apply([pod(f"stress-{i}", NS, ASSERT_GPU,
                       {"gpu": {"resourceClaimName": "shared"}}, node)
                   for i in range(PODS_PER_LOOP)])
        e2e.wait_until(240, f"loop {loop} pods Succeeded",
                       lambda: e2e.all_pods_phase(NS, "Succeeded"))
        loop_s.append(time.monotonic() - t0)
        for i in range(PODS_PER_LOOP):
            e2e.delete(PODS, f"stress-{i}", NS)
        e2e.wait_until(90, f"loop {loop} pods drained",
                       lambda: not e2e.pods(NS))
    return {"stress_pods": PODS_PER_LOOP, "stress_loops": LOOPS,
            "loop_s": loop_s, "churn_p95_s": p95(loop_s)}
