"""ComputeDomain lifecycle (tests/e2e/test_cd_lifecycle.sh): a domain
across both nodes; its workload channel template stamped in the domain's
namespace; one workload pod per node; the domain Ready once both daemons
register; each workload reads its rendezvous env (NODE_RANK, NNODES,
MASTER_ADDR, MASTER_PORT); teardown removes the daemon DaemonSet."""

from __future__ import annotations

import time
from typing import Dict

from tpu_dra_torch.e2e.helpers import (
    E2E, check, compute_domain, namespace, pod, sleeping,
)
from tpu_dra_torch.k8s.resources import COMPUTEDOMAINS, PODS, RESOURCECLAIMTEMPLATES

NS = "cd-e2e"
CD = "cd-e2e-domain"


def workload(i: int) -> Dict:
    return pod(f"wl-{i}", NS, sleeping(600),
               {"ch": {"resourceClaimTemplateName": f"{CD}-channel"}},
               f"n{i}")


def run(e2e: E2E) -> Dict:
    e2e.apply([namespace(NS), compute_domain(CD, NS, 2, single=True)])
    e2e.wait_until(60, "workload RCT", lambda: e2e.get(
        RESOURCECLAIMTEMPLATES, f"{CD}-channel", NS))
    t0 = time.monotonic()
    e2e.apply([workload(i) for i in range(2)])
    # The channel prepare fails and retries until the domain is Ready.
    e2e.wait_cd(NS, CD, 240, "CD Ready")
    ready_s = time.monotonic() - t0
    e2e.wait_until(120, "workloads Running",
                   lambda: e2e.all_pods_phase(NS, "Running"))
    envs = {}
    for i in range(2):
        envs[f"n{i}"] = e2e.wait_until(
            30, f"wl-{i}'s rendezvous env",
            lambda i=i: e2e.last_json(NS, f"wl-{i}"))
    check(sorted(e["NODE_RANK"] for e in envs.values()) == ["0", "1"],
          f"workloads' NODE_RANK: {envs}")
    check({e["NNODES"] for e in envs.values()} == {"2"},
          f"workloads' NNODES: {envs}")
    check(len({(e["MASTER_ADDR"], e["MASTER_PORT"])
               for e in envs.values()}) == 1
          and None not in {e["MASTER_ADDR"] for e in envs.values()},
          f"workloads' rendezvous address: {envs}")
    for i in range(2):
        e2e.delete(PODS, f"wl-{i}", NS)
    e2e.delete(COMPUTEDOMAINS, CD, NS)
    e2e.wait_until(120, "CD deleted",
                   lambda: e2e.get(COMPUTEDOMAINS, CD, NS) is None)
    e2e.wait_until(120, "daemon DS torn down", lambda: not e2e.daemon_sets())
    return {"cd_ready_s": ready_s, "envs": envs}
