"""Chart up/downgrade with state in flight (tests/e2e/test_updowngrade.sh):
with a prepared GPU claim (the holder pod) and a Ready ComputeDomain, a
render with ``--set`` changes (logVerbosity 5: new pod templates for
every driver component; the CRD re-applied) is installed. Everything
survives: the plugins roll in with the new verbosity and so do the
stamped daemon pods, the holder keeps running, the domain is Ready
again, a new claim prepares, and the holder's claim, prepared before the
plugin restarted, unprepares (the restarted plugin knows it from its
checkpoint journal). Then the original render is installed again. The
reference's v1-checkpoint leg has no counterpart: the port never wrote
a v1 checkpoint."""

from __future__ import annotations

import os
from typing import Dict

from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.deploy.render import overrides
from tpu_dra_torch.e2e.helpers import (
    E2E, PRINT_ENV, check, compute_domain, gpu_template, namespace, pod,
    sleeping,
)
from tpu_dra_torch.k8s.resources import COMPUTEDOMAINS, PODS, RESOURCECLAIMTEMPLATES

NS = "updown-e2e"
CD = "updown-cd"
UPGRADE_SETS = ["logVerbosity=5"]


def _verbosity_everywhere(e2e: E2E, part: str, want: str) -> bool:
    pods = e2e.driver_pods(part)
    return bool(pods) and all(
        set(e2e.env_of(p, "LOG_VERBOSITY")) == {want}
        and (p.get("status") or {}).get("phase") == "Running" for p in pods)


def _install(e2e: E2E, sets) -> str:
    """Apply the chart rendered with `sets`; returns its LOG_VERBOSITY."""
    docs = manifests.render(overrides(sets))
    e2e.apply(docs)
    (ds,) = [d for d in docs if d["kind"] == "DaemonSet"]
    (verbosity,) = set(e2e.env_of(ds, "LOG_VERBOSITY"))
    return verbosity


def _claim_specs(e2e: E2E, node: str):
    return CDIHandler(os.path.join(e2e.cluster.node_dir(node), "fs", "var",
                                   "run", "cdi")).list_claim_uids()


def run(e2e: E2E) -> Dict:
    e2e.wait_until(120, "driver pods Ready", e2e.driver_pods_ready)
    holder_node = "n0"
    e2e.apply([namespace(NS), gpu_template("one-gpu", NS),
               pod("holder", NS, sleeping(900),
                   {"gpu": {"resourceClaimTemplateName": "one-gpu"}},
                   holder_node),
               compute_domain(CD, NS, 1)])
    e2e.wait_until(60, "workload RCT", lambda: e2e.get(
        RESOURCECLAIMTEMPLATES, f"{CD}-channel", NS))
    e2e.apply([pod("cd-wl", NS, sleeping(900),
                   {"ch": {"resourceClaimTemplateName": f"{CD}-channel"}},
                   "n1")])
    e2e.wait_until(120, "holder pod Running",
                   lambda: e2e.pod_phase(NS, "holder") == "Running")
    e2e.wait_cd(NS, CD, 240, "CD Ready")
    holder_uid = e2e.claim_of(e2e.pod(NS, "holder"), "gpu")["metadata"][
        "uid"]
    check(holder_uid in _claim_specs(e2e, holder_node),
          "the holder's claim spec is not on its node")
    plugin_uids = {p["metadata"]["uid"]
                   for p in e2e.driver_pods("kubelet-plugin")}

    # UPGRADE
    up = _install(e2e, UPGRADE_SETS)
    e2e.wait_until(180, "upgraded plugin pods rolled in",
                   lambda: _verbosity_everywhere(e2e, "kubelet-plugin", up))
    check(not plugin_uids & {p["metadata"]["uid"]
                             for p in e2e.driver_pods("kubelet-plugin")},
          "the plugin pods were not replaced")
    e2e.wait_until(180, "driver pods Ready after the upgrade",
                   e2e.driver_pods_ready)
    check(e2e.pod_phase(NS, "holder") == "Running",
          "the holder pod lost its claim")
    e2e.wait_cd(NS, CD, 240, "CD Ready after the upgrade")
    e2e.wait_until(180, "upgraded daemon pods rolled in",
                   lambda: _verbosity_everywhere(e2e, "gpu-cd-daemon", up))
    e2e.apply([pod("fresh", NS, PRINT_ENV,
                   {"gpu": {"resourceClaimTemplateName": "one-gpu"}},
                   "n1")])
    e2e.wait_until(120, "fresh pod Succeeded",
                   lambda: e2e.pod_phase(NS, "fresh") == "Succeeded")
    check(e2e.last_json(NS, "fresh")["CUDA_VISIBLE_DEVICES"],
          "the fresh pod saw no GPU")
    # The claim prepared before the restart unprepares after it.
    e2e.delete(PODS, "holder", NS)
    e2e.wait_until(120, "holder gone", lambda: e2e.pod(NS, "holder") is None)
    e2e.wait_until(60, "the holder's claim spec removed", lambda:
                   holder_uid not in _claim_specs(e2e, holder_node))

    # DOWNGRADE
    down = _install(e2e, [])
    e2e.wait_until(180, "downgraded plugin pods rolled in",
                   lambda: _verbosity_everywhere(e2e, "kubelet-plugin",
                                                 down))
    e2e.wait_until(180, "driver pods Ready after the downgrade",
                   e2e.driver_pods_ready)
    e2e.wait_cd(NS, CD, 240, "CD Ready after the downgrade")
    for name in ("cd-wl", "fresh"):
        e2e.delete(PODS, name, NS)
    e2e.delete(COMPUTEDOMAINS, CD, NS)
    e2e.wait_until(120, "CD deleted",
                   lambda: e2e.get(COMPUTEDOMAINS, CD, NS) is None)
    return {"upgrade": UPGRADE_SETS, "verbosity": [up, down]}
