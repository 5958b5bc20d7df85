"""Debug and observability (tests/e2e/test_debug.sh): SIGUSR2 makes a
live kubelet-plugin pod dump its threads' stacks (infra/debug.py), and
the chart's LOG_VERBOSITY reaches the driver pods and the domain-daemon
pods the controller stamps."""

from __future__ import annotations

import os
import signal
from typing import Dict

from tpu_dra_torch.e2e.helpers import (
    E2E, check, compute_domain, namespace, pod, sleeping,
)
from tpu_dra_torch.infra.debug import STACK_DUMP_NAME
from tpu_dra_torch.k8s.resources import (
    COMPUTEDOMAINS, DAEMONSETS, PODS, RESOURCECLAIMTEMPLATES,
)

NS = "debug-e2e"
CD = "debug-cd"


def run(e2e: E2E) -> Dict:
    plugin = e2e.wait_until(120, "a kubelet-plugin pod Running", lambda: next(
        (p for p in e2e.driver_pods("kubelet-plugin")
         if (p.get("status") or {}).get("phase") == "Running"), None))
    name = plugin["metadata"]["name"]
    ctr = plugin["spec"]["containers"][0]["name"]
    # The sim's kubectl exec kill: the container's process is on this
    # host, its pid published as containerID sim://<pid>.
    dump = os.path.join(e2e.pod_dir(plugin), "tmp", STACK_DUMP_NAME)
    if os.path.exists(dump):
        os.unlink(dump)
    os.kill(e2e.container_pid(plugin, ctr), signal.SIGUSR2)
    e2e.wait_until(30, f"stack dump at {dump}",
                   lambda: os.path.exists(dump) and os.path.getsize(dump))
    with open(dump) as f:
        text = f.read()
    check("--- thread" in text, "the dump has no thread stacks")

    (ds,) = [d for d in e2e.api.list(DAEMONSETS, namespace=e2e.ns)
             if "kubelet-plugin" in d["metadata"]["name"]]
    want = set(e2e.env_of(ds, "LOG_VERBOSITY"))
    check(len(want) == 1 and None not in want,
          f"the kubelet-plugin DaemonSet's LOG_VERBOSITY: {want}")
    (want_v,) = want
    got = set(e2e.env_of(e2e.get(PODS, name, e2e.ns), "LOG_VERBOSITY"))
    check(got == {want_v}, f"driver pod LOG_VERBOSITY {got}, want {want_v}")

    # The daemon DaemonSet only makes pods on labeled nodes; a channel
    # claim pulls the label, so one workload summons it.
    e2e.apply([namespace(NS), compute_domain(CD, NS, 1)])
    e2e.wait_until(60, "the domain's channel template", lambda: e2e.get(
        RESOURCECLAIMTEMPLATES, f"{CD}-channel", NS))
    e2e.apply([pod("dbg-wl", NS, sleeping(300),
                   {"ch": {"resourceClaimTemplateName": f"{CD}-channel"}},
                   e2e.fake_node)])
    daemon = e2e.wait_until(180, "CD daemon pod lands", lambda: next(
        iter(e2e.driver_pods("gpu-cd-daemon")), None))
    got_d = set(e2e.env_of(daemon, "LOG_VERBOSITY"))
    check(got_d == {want_v},
          f"daemon pod LOG_VERBOSITY {got_d}, want {want_v}")
    e2e.delete(PODS, "dbg-wl", NS)
    e2e.delete(COMPUTEDOMAINS, CD, NS)
    e2e.wait_until(120, "CD deleted",
                   lambda: e2e.get(COMPUTEDOMAINS, CD, NS) is None)
    return {"plugin_pod": name, "dump_bytes": len(text),
            "log_verbosity": want_v}
