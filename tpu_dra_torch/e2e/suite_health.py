"""Device health (tests/e2e/test_health.sh): a critical event written to
a simulated node's health-events file takes that GPU out of the node's
ResourceSlice, the other node is untouched, and a `recovered` event
re-admits it. On a card node the event goes to the simulated node (no
XID can be raised on the card on purpose)."""

from __future__ import annotations

from typing import Dict

from tpu_dra_torch.e2e.helpers import E2E, check
from tpu_dra_torch.native.gpuinfo import HealthEvent, append_health_event

# XID 79, "GPU has fallen off the bus": critical, not in the skip list.
CRITICAL = HealthEvent(0, "xid", 79, "gpu fallen off the bus")
RECOVERED = HealthEvent(0, "recovered", 0, "serviced")


def count_gpus(e2e: E2E, node: str) -> int:
    return sum(1 for d in e2e.gpu_slice_devices(node)
               if d["attributes"]["type"]["string"] == "gpu")


def run(e2e: E2E) -> Dict:
    node, other = e2e.fake_node, e2e.other_node
    e2e.wait_until(120, f"{node} GPU slice published",
                   lambda: count_gpus(e2e, node))
    before, other_before = count_gpus(e2e, node), count_gpus(e2e, other)
    check(before >= 2, f"expected >= 2 GPUs on {node}, got {before}")
    events = e2e.cluster.events_file(node)
    append_health_event(events, CRITICAL)
    e2e.wait_until(60, f"GPU 0 yanked from {node}'s ResourceSlice",
                   lambda: count_gpus(e2e, node) < before)
    after = count_gpus(e2e, node)
    check(not any(d["name"] == "gpu-0" for d in e2e.gpu_slice_devices(node)),
          f"{node} still publishes gpu-0")
    check(count_gpus(e2e, other) == other_before,
          f"healthy node {other} lost devices")
    append_health_event(events, RECOVERED)
    e2e.wait_until(60, f"GPU 0 re-admitted to {node}'s ResourceSlice",
                   lambda: count_gpus(e2e, node) == before)
    return {"node": node, "gpus_before": before, "gpus_after": after}
