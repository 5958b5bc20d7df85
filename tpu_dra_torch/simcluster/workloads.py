"""WorkloadController: DaemonSet/Deployment -> Pod stamping + status
(counterpart of tpu_dra/simcluster/workloads.py).

The kube-controller-manager analog the chart and the CD machinery need:
the chart's plugin DaemonSet and controller Deployment become pods, and
the CD controller stamps per-CD DaemonSets whose nodeSelector is the CD
label;
something must turn those into pods as nodes get labeled, keep the DS
status fresh (desiredNumberScheduled is the CD controller's lower bound
for open-ended readiness; per-node readiness itself comes from
cd.status.nodes — controller._update_readiness), and delete pods when
labels go away (the workload-following teardown).
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from typing import Dict, List, Optional

from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ApiError, ConflictError, NotFoundError,
)
from tpu_dra_torch.k8s.resources import DAEMONSETS, DEPLOYMENTS, NODES, PODS

log = logging.getLogger("simcluster.workloads")


def _template_hash(owner: Dict) -> str:
    """Stable hash of a DS/Deployment pod template — the pod-template-hash
    analog that lets the sim roll pods on chart upgrades."""
    payload = json.dumps(owner["spec"]["template"], sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:10]


class WorkloadController:
    def __init__(self, client: ApiClient, interval: float = 0.2):
        self._client = client
        self._interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sim-workloads")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001
                log.exception("workload reconcile failed")

    # ------------------------------------------------------------------

    def reconcile_once(self) -> None:
        nodes = self._client.list(NODES)
        pods = self._client.list(PODS)
        daemonsets = self._client.list(DAEMONSETS)
        deployments = self._client.list(DEPLOYMENTS)
        for ds in daemonsets:
            try:
                self._reconcile_daemonset(ds, nodes, pods)
            except ConflictError:
                continue
        for dep in deployments:
            try:
                self._reconcile_deployment(dep, pods)
            except ConflictError:
                continue
        # Orphan GC (the CD controller's CleanupManager analog): a
        # stamped pod whose owning
        # DS/Deployment is gone would otherwise linger forever — e.g. a
        # per-CD daemon pod after its CD (and thus its DaemonSet) was
        # deleted mid-flight.
        owners = {(d["metadata"].get("namespace", "default"),
                   f"ds-{d['metadata']['name']}") for d in daemonsets}
        owners |= {(d["metadata"].get("namespace", "default"),
                    f"deploy-{d['metadata']['name']}") for d in deployments}
        for p in pods:
            tag = (p["metadata"].get("labels") or {}).get("sim/owner")
            ns = p["metadata"].get("namespace", "default")
            if tag and (ns, tag) not in owners:
                self._delete_pod(p["metadata"]["name"], ns)

    # -- DaemonSets -----------------------------------------------------

    def _reconcile_daemonset(self, ds: Dict, nodes: List[Dict],
                             pods: List[Dict]) -> None:
        ns = ds["metadata"].get("namespace", "default")
        name = ds["metadata"]["name"]
        selector = (ds["spec"]["template"]["spec"]
                    .get("nodeSelector") or {})
        want_nodes = {
            n["metadata"]["name"] for n in nodes
            if all((n["metadata"].get("labels") or {}).get(k) == v
                   for k, v in selector.items())}
        owned = {p["metadata"]["name"]: p for p in pods
                 if p["metadata"].get("namespace") == ns
                 and (p["metadata"].get("labels") or {}).get(
                     "sim/owner") == f"ds-{name}"}
        tmpl_hash = _template_hash(ds)
        for node in sorted(want_nodes):
            pod_name = f"{name}-{node}"
            if pod_name not in owned:
                self._create_pod(ds, pod_name, ns, f"ds-{name}",
                                 node_name=node)
        for pod_name, pod in owned.items():
            if pod["spec"].get("nodeName") not in want_nodes:
                # Node left the selector (label removed): workload-following
                # teardown.
                self._delete_pod(pod_name, ns)
            elif (pod["metadata"]["labels"].get("sim/template-hash")
                  != tmpl_hash):
                # Template changed (chart upgrade): roll the pod — delete
                # now, the next reconcile recreates it from the new
                # template (the DaemonSet RollingUpdate analog; the CD
                # controller's own template-hash convergence depends on
                # this, controller.py).
                self._delete_pod(pod_name, ns)
        ready = sum(1 for p in owned.values()
                    if self._pod_ready(p)
                    and p["spec"].get("nodeName") in want_nodes)
        status = {"desiredNumberScheduled": len(want_nodes),
                  "currentNumberScheduled": len(owned),
                  "numberReady": ready}
        if (ds.get("status") or {}) != status:
            ds["status"] = status
            try:
                self._client.update_status(DAEMONSETS, ds, ns)
            except ApiError:
                pass

    # -- Deployments ----------------------------------------------------

    def _reconcile_deployment(self, dep: Dict, pods: List[Dict]) -> None:
        ns = dep["metadata"].get("namespace", "default")
        name = dep["metadata"]["name"]
        replicas = int(dep["spec"].get("replicas", 1))
        owned = {p["metadata"]["name"]: p for p in pods
                 if p["metadata"].get("namespace") == ns
                 and (p["metadata"].get("labels") or {}).get(
                     "sim/owner") == f"deploy-{name}"}
        tmpl_hash = _template_hash(dep)
        for i in range(replicas):
            pod_name = f"{name}-{i}"
            if pod_name not in owned:
                self._create_pod(dep, pod_name, ns, f"deploy-{name}")
        for pod_name, pod in list(owned.items()):
            idx = pod_name.rsplit("-", 1)[-1]
            if idx.isdigit() and int(idx) >= replicas:
                self._delete_pod(pod_name, ns)
            elif (pod["metadata"]["labels"].get("sim/template-hash")
                  != tmpl_hash):
                self._delete_pod(pod_name, ns)  # roll on template change
        ready = sum(1 for p in owned.values() if self._pod_ready(p))
        status = {"replicas": len(owned), "readyReplicas": ready,
                  "availableReplicas": ready}
        if (dep.get("status") or {}) != status:
            dep["status"] = status
            try:
                self._client.update_status(DEPLOYMENTS, dep, ns)
            except ApiError:
                pass

    # -- shared ---------------------------------------------------------

    def _create_pod(self, owner: Dict, pod_name: str, ns: str,
                    owner_tag: str, node_name: Optional[str] = None) -> None:
        template = owner["spec"]["template"]
        labels = dict(template.get("metadata", {}).get("labels") or {})
        labels["sim/owner"] = owner_tag
        labels["sim/template-hash"] = _template_hash(owner)
        spec = dict(template["spec"])
        if node_name:
            spec = {**spec, "nodeName": node_name}
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": pod_name, "namespace": ns,
                         "labels": labels},
            "spec": spec,
        }
        try:
            self._client.create(PODS, pod, namespace=ns)
            log.info("stamped pod %s/%s (owner %s)", ns, pod_name, owner_tag)
        except (AlreadyExistsError, ConflictError):
            pass

    def _delete_pod(self, name: str, ns: str) -> None:
        try:
            self._client.delete(PODS, name, ns)
            log.info("deleted pod %s/%s", ns, name)
        except NotFoundError:
            pass

    @staticmethod
    def _pod_ready(pod: Dict) -> bool:
        for cond in (pod.get("status") or {}).get("conditions") or []:
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return False
