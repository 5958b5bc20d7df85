"""ComputeDomain failover (tests/e2e/test_cd_failover.sh): every domain
daemon of a Ready two-node domain killed, the domain leaves Ready and
heals within HEAL_BOUND_S; then a worker pod deleted (its node leaves
the domain's status) and re-created (the domain heals again).

The shell suite waits for NotReady; the controller (the reference's and
the port's, cdcontroller/controller.py:376) reports a once-Ready domain
that lost a member as Degraded, so this suite waits for either and
records which it saw."""

from __future__ import annotations

import os
import signal
import time
from typing import Dict

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.e2e.helpers import (
    E2E, check, compute_domain, namespace, pod, sleeping,
)
from tpu_dra_torch.k8s.resources import COMPUTEDOMAINS, PODS, RESOURCECLAIMTEMPLATES

NS = "cd-failover"
CD = "cd-failover-domain"
HEAL_BOUND_S = 240.0
NOT_READY = apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY
DEGRADED = apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED


def workload(i: int) -> Dict:
    return pod(f"wl-{i}", NS, sleeping(900),
               {"ch": {"resourceClaimTemplateName": f"{CD}-channel"}},
               f"n{i}")


def run(e2e: E2E) -> Dict:
    e2e.apply([namespace(NS), compute_domain(CD, NS, 2)])
    e2e.wait_until(60, "workload RCT", lambda: e2e.get(
        RESOURCECLAIMTEMPLATES, f"{CD}-channel", NS))
    e2e.apply([workload(i) for i in range(2)])
    e2e.wait_cd(NS, CD, 240, "CD Ready")

    # Fault 1: kill every domain daemon (the shell suite's pkill of the
    # daemon wrapper; its pid is the pod's published containerID).
    daemons = e2e.driver_pods("gpu-cd-daemon")
    check(len(daemons) == 2, f"want a daemon per node: {daemons}")
    for d in daemons:
        os.kill(e2e.container_pid(d, d["spec"]["containers"][0]["name"]),
                signal.SIGTERM)
    fault_status = e2e.wait_cd(NS, CD, 120,
                               "CD NotReady or Degraded after the fault",
                               (NOT_READY, DEGRADED))
    t0 = time.monotonic()
    e2e.wait_cd(NS, CD, HEAL_BOUND_S, "CD Ready again")
    heal_daemons_s = time.monotonic() - t0

    # Fault 2: a worker pod deleted: its channel's release shrinks the
    # domain; re-created, it re-joins.
    e2e.delete(PODS, "wl-0", NS)

    def n0_gone():
        cd = e2e.api.get(COMPUTEDOMAINS, CD, NS)
        return not any(n.get("name") == "n0" for n in
                       (cd.get("status") or {}).get("nodes") or [])

    e2e.wait_until(120, "n0 deregistered from CD status", n0_gone)
    e2e.wait_cd(NS, CD, 120, "CD not Ready with one member",
                (NOT_READY, DEGRADED))
    e2e.wait_until(90, "wl-0 gone", lambda: e2e.pod(NS, "wl-0") is None)
    e2e.apply([workload(0)])
    t0 = time.monotonic()
    e2e.wait_cd(NS, CD, HEAL_BOUND_S, "CD Ready after the worker re-joined")
    heal_worker_s = time.monotonic() - t0
    e2e.wait_until(120, "wl-0 Running again",
                   lambda: e2e.pod_phase(NS, "wl-0") == "Running")
    for i in range(2):
        e2e.delete(PODS, f"wl-{i}", NS)
    e2e.delete(COMPUTEDOMAINS, CD, NS)
    return {"fault_status": fault_status, "heal_daemons_s": heal_daemons_s,
            "heal_worker_s": heal_worker_s}
