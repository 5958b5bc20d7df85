"""What every e2e suite speaks (counterpart of tests/e2e/helpers.sh and
cleanup.sh, and of the kubectl subset hack/kubectl_shim.py serves them):
apply documents, read objects, pod phases and logs, ``wait_until`` with a
deadline, and the cleanup of every namespace and object a suite made,
run before each suite (tests/e2e/run.sh).

A suite is a function ``run(e2e: E2E) -> dict`` that raises
``SuiteFailure`` (or any exception) when an assertion of its shell
counterpart fails; the dict holds what it measured.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.k8s.resources import (
    COMPUTEDOMAINS, DAEMONSETS, DEPLOYMENTS, NAMESPACES, PODS,
    RESOURCECLAIMS, RESOURCECLAIMTEMPLATES, RESOURCESLICES,
)
from tpu_dra_torch.k8s.client import GVR, NotFoundError
from tpu_dra_torch.simcluster.gvk import gvr_for_doc

log = logging.getLogger("tpu_dra_torch.e2e")

SYSTEM_NAMESPACES = ("default", "kube-system", "kube-public",
                     "kube-node-lease", manifests.DEFAULT_NAMESPACE)
# How often wait_until polls (the shell suites poll once a second).
POLL_S = 0.2
# A container that prints, as its last line, the JSON of these env vars.
ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "NODE_RANK", "NNODES", "MASTER_ADDR",
            "MASTER_PORT")
PRINT_ENV = ["python", "-c",
             "import json, os; print(json.dumps({k: os.environ.get(k) "
             f"for k in {ENV_KEYS!r}}}), flush=True)"]
# The training pod off the card: claim-child at a small width, on the
# CPU, two steps; on the card: the flagship at full width, CARD_STEPS
# steps.
SMALL_CONFIG = json.dumps(dict(vocab=128, d_model=64, n_heads=2,
                               n_layers=2, d_ff=128, max_seq=64,
                               dtype="float32"))
CPU_TRAIN = ["python", "-m", "tpu_dra_torch.bench", "claim-child",
             "--device-type", "cpu", "--steps", "2", "--config",
             SMALL_CONFIG]
CARD_STEPS = 3
CARD_TRAIN = ["python", "-m", "tpu_dra_torch.bench", "claim-child",
              "--steps", str(CARD_STEPS)]


class SuiteFailure(AssertionError):
    """An assertion of a suite failed (the shell suites' `die`)."""


def check(ok: Any, what: str) -> None:
    if not ok:
        raise SuiteFailure(what)


def sleeping(seconds: int) -> List[str]:
    """A container that prints PRINT_ENV's line, then sleeps `seconds`
    (a workload that holds its claims)."""
    return ["python", "-c",
            f"{PRINT_ENV[2]}\nimport time\ntime.sleep({seconds})"]


class E2E:
    """One cluster under test, `up` (a started e2e.cluster.E2ECluster:
    its SimCluster with the chart's default render installed). fake_node
    is the node whose GPUs the sim makes (n1 with a card node, else n0),
    other_node the other one. A training pod runs train_command: the
    flagship on the card with a card node, else a small model on the
    CPU."""

    def __init__(self, up):
        from tpu_dra_torch.e2e.cluster import MIG_GPU

        self.cluster = up.cluster
        self.api = up.cluster.api
        self.ns = manifests.DEFAULT_NAMESPACE
        self.card_node = up.card_node
        self.fake_node = "n1" if up.card_node else "n0"
        self.other_node = "n0" if up.card_node else "n1"
        self.train_command = CARD_TRAIN if up.card_node else CPU_TRAIN
        self.mig_gpu = MIG_GPU

    # -- objects --------------------------------------------------------

    def apply(self, docs: Iterable[Dict]) -> None:
        """kubectl apply -f: create each document, update it where it
        exists."""
        self.cluster.install([d for d in docs if d])

    def get(self, gvr: GVR, name: str,
            ns: Optional[str] = None) -> Optional[Dict]:
        try:
            return self.api.get(gvr, name, ns)
        except NotFoundError:
            return None

    def delete(self, gvr: GVR, name: str, ns: Optional[str] = None) -> None:
        try:
            self.api.delete(gvr, name, ns)
        except NotFoundError:
            pass

    def delete_docs(self, docs: Iterable[Dict]) -> None:
        """kubectl delete -f --ignore-not-found."""
        for d in docs:
            gvr = gvr_for_doc(d)
            self.delete(gvr, d["metadata"]["name"],
                        d["metadata"].get("namespace"))

    def pods(self, ns: str) -> List[Dict]:
        return self.api.list(PODS, namespace=ns)

    def pod(self, ns: str, name: str) -> Optional[Dict]:
        return self.get(PODS, name, ns)

    def pod_phase(self, ns: str, name: str) -> str:
        p = self.pod(ns, name)
        return ((p or {}).get("status") or {}).get("phase", "")

    def all_pods_phase(self, ns: str, phase: str) -> bool:
        pods = self.pods(ns)
        return bool(pods) and all(
            (p.get("status") or {}).get("phase") == phase for p in pods)

    def pod_ready(self, pod: Dict) -> bool:
        return any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in (pod.get("status") or {}).get("conditions")
                   or [])

    def driver_pods_ready(self) -> bool:
        pods = self.pods(self.ns)
        return bool(pods) and all(
            (p.get("status") or {}).get("phase") == "Running"
            and self.pod_ready(p) for p in pods)

    def log(self, ns: str, pod: str, ctr: str = "ctr") -> str:
        p = self.pod(ns, pod)
        check(p is not None, f"no pod {ns}/{pod}")
        return self.cluster.pod_log(p, ctr)

    def last_json(self, ns: str, pod: str, ctr: str = "ctr") -> Dict:
        """The JSON object a container printed last."""
        return json.loads(self.log(ns, pod, ctr).strip().splitlines()[-1])

    def claim_of(self, pod: Dict, entry: str) -> Dict:
        """The ResourceClaim behind a pod's resourceClaims entry."""
        ns = pod["metadata"]["namespace"]
        for src in pod["spec"].get("resourceClaims") or []:
            if src["name"] == entry and src.get("resourceClaimName"):
                return self.api.get(RESOURCECLAIMS,
                                    src["resourceClaimName"], ns)
        name = {s["name"]: s["resourceClaimName"] for s in
                (pod.get("status") or {}).get("resourceClaimStatuses")
                or []}[entry]
        return self.api.get(RESOURCECLAIMS, name, ns)

    @staticmethod
    def results(claim: Dict) -> List[Dict]:
        return claim["status"]["allocation"]["devices"]["results"]

    def gpu_slice_devices(self, node: str) -> List[Dict]:
        """The devices of `node`'s gpu.dev ResourceSlices."""
        return [d for sl in self.api.list(RESOURCESLICES)
                if sl["spec"].get("nodeName") == node
                and sl["spec"].get("driver") == apitypes.GPU_DRIVER_NAME
                for d in sl["spec"].get("devices") or []]

    def device_attr(self, node: str, device: str, attr: str):
        for d in self.gpu_slice_devices(node):
            if d["name"] == device:
                return next(iter(d["attributes"][attr].values()))
        raise SuiteFailure(f"{node} publishes no device {device}")

    def driver_pods(self, part: str) -> List[Dict]:
        """The driver namespace's pods whose name holds `part`."""
        return [p for p in self.pods(self.ns)
                if part in p["metadata"]["name"]]

    def container_pid(self, pod: Dict, ctr: str) -> int:
        """The host pid of a running container (the sim publishes it as
        containerID sim://<pid>)."""
        for cs in (pod.get("status") or {}).get("containerStatuses") or []:
            cid = cs.get("containerID", "")
            if cs["name"] == ctr and cid.startswith("sim://"):
                return int(cid[len("sim://"):])
        raise SuiteFailure(f"{pod['metadata']['name']}:{ctr} has no pid")

    def pod_dir(self, pod: Dict) -> str:
        return os.path.join(self.cluster.node_dir(pod["spec"]["nodeName"]),
                            "pods", pod["metadata"]["uid"])

    @staticmethod
    def env_of(spec_or_pod: Dict, name: str) -> List[Optional[str]]:
        """`name`'s value in each container of a pod, or of a
        DaemonSet's or Deployment's pod template."""
        spec = spec_or_pod["spec"]
        spec = spec["template"]["spec"] if "template" in spec else spec
        return [next((e.get("value") for e in c.get("env") or []
                      if e["name"] == name), None)
                for c in spec["containers"]]

    def cd_status(self, ns: str, name: str) -> str:
        cd = self.get(COMPUTEDOMAINS, name, ns)
        return ((cd or {}).get("status") or {}).get("status", "")

    def wait_cd(self, ns: str, name: str, timeout: float, what: str,
                statuses=(apitypes.COMPUTE_DOMAIN_STATUS_READY,)) -> str:
        """wait_until the domain's status is one of `statuses` (returned);
        a timeout names the domain-daemon pods and their logs' tails."""
        try:
            return self.wait_until(timeout, what, lambda: (
                self.cd_status(ns, name) in statuses
                and self.cd_status(ns, name)))
        except SuiteFailure as e:
            raise SuiteFailure(f"{e}; status {self.cd_status(ns, name)!r}"
                               f"\n{self.daemon_log_tails()}") from None

    def daemon_log_tails(self, chars: int = 1500) -> str:
        out = []
        for p in self.driver_pods("gpu-cd-daemon"):
            phase = (p.get("status") or {}).get("phase")
            try:
                text = self.cluster.pod_log(p, p["spec"]["containers"][0][
                    "name"])[-chars:]
            except (OSError, KeyError) as err:
                text = f"(no log: {err})"
            out.append(f"== {p['metadata']['name']} ({phase})\n{text}")
        return "\n".join(out) or "(no domain-daemon pod)"

    # -- waiting --------------------------------------------------------

    @staticmethod
    def wait_until(timeout: float, what: str, pred: Callable[[], Any]):
        """pred() until it returns something truthy, which is returned;
        SuiteFailure at the deadline. An exception in pred counts as not
        yet (an API read racing a write)."""
        t0 = time.monotonic()
        while True:
            try:
                got = pred()
            except Exception:  # noqa: BLE001 # drflow: swallow-ok[a read racing a write counts as not yet; the deadline bounds the wait]
                got = None
            waited = time.monotonic() - t0
            if got:
                log.info("waited %.1fs for: %s", waited, what)
                return got
            if waited >= timeout:
                raise SuiteFailure(
                    f"timed out ({timeout:g}s) waiting for: {what}")
            time.sleep(POLL_S)

    # -- cleanup (tests/e2e/cleanup.sh) ---------------------------------

    def test_namespaces(self) -> List[str]:
        names = {n["metadata"]["name"] for n in self.api.list(NAMESPACES)}
        for gvr in (PODS, RESOURCECLAIMS, RESOURCECLAIMTEMPLATES,
                    COMPUTEDOMAINS):
            names |= {o["metadata"].get("namespace", "default")
                      for o in self.api.list(gvr)}
        return sorted(n for n in names if n not in SYSTEM_NAMESPACES)

    def cleanup(self, timeout: float = 90.0) -> None:
        """Delete every non-system namespace's pods, ComputeDomains,
        claims and templates, then the namespace, and wait until the
        pods have drained and the domains' daemon DaemonSets are gone
        (deletion is asynchronous: a suite that re-applies a spec while
        the old pod exists would read the old pod's phase and logs)."""
        for ns in self.test_namespaces():
            for gvr in (PODS, COMPUTEDOMAINS, RESOURCECLAIMS,
                        RESOURCECLAIMTEMPLATES):
                for obj in self.api.list(gvr, namespace=ns):
                    self.delete(gvr, obj["metadata"]["name"], ns)
            self.delete(NAMESPACES, ns)

        def drained():
            return not any(self.pods(ns) or
                           self.api.list(COMPUTEDOMAINS, namespace=ns)
                           for ns in self.test_namespaces()) and \
                not self.daemon_sets() and not self.mps_deployments()

        self.wait_until(timeout, "previous suites' objects drained", drained)

    def daemon_sets(self) -> List[Dict]:
        """The stamped domain-daemon DaemonSets in the driver namespace."""
        from tpu_dra_torch.cdcontroller.templates import DAEMON_PREFIX
        return [d for d in self.api.list(DAEMONSETS, namespace=self.ns)
                if d["metadata"]["name"].startswith(DAEMON_PREFIX)]

    def mps_deployments(self) -> List[Dict]:
        from tpu_dra_torch.gpuplugin.sharing import MPS_APP_LABEL
        return self.api.list(DEPLOYMENTS, namespace=self.ns,
                             label_selector="app.kubernetes.io/name="
                                            f"{MPS_APP_LABEL}")


def namespace(name: str) -> Dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


def pod(name: str, ns: str, command: List[str],
        claims: Optional[Dict[str, Dict]] = None,
        node: Optional[str] = None) -> Dict:
    """A one-container pod (restartPolicy Never) whose container uses
    every claim of `claims` (pod-claim name -> source), bound to `node`
    where given."""
    claims = claims or {}
    spec: Dict = {
        "restartPolicy": "Never",
        "containers": [{"name": "ctr", "image": manifests.DEFAULT_IMAGE,
                        "command": list(command),
                        "resources": {"claims": [{"name": n}
                                                 for n in claims]}}],
        "resourceClaims": [{"name": n, **src} for n, src in claims.items()],
    }
    if node:
        spec["nodeName"] = node
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns}, "spec": spec}


def compute_domain(name: str, ns: str, num_nodes: int,
                   single: bool = False) -> Dict:
    channel: Dict = {"resourceClaimTemplate": {"name": f"{name}-channel"}}
    if single:
        channel["allocationMode"] = apitypes.ALLOCATION_MODE_SINGLE
    return {"apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"numNodes": num_nodes, "channel": channel}}


def gpu_template(name: str, ns: str) -> Dict:
    return {"apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"spec": {"devices": {"requests": [{
                "name": "gpu", "exactly": {
                    "deviceClassName": manifests.DEVICE_CLASS_GPU}}]}}}}
