"""ComputeDomain reconciliation (counterpart of
tpu_dra/cdcontroller/controller.py).

One `Controller` wires five informers (ComputeDomains, DaemonSets, RCTs,
daemon Pods, Nodes) into a rate-limited work queue:

- add/update: add finalizer, stamp daemon RCT + DaemonSet (driver
  namespace) and the user-facing workload RCT (CD namespace); flip CD
  status from the per-node readiness the domain daemons maintain in
  cd.status.nodes (_update_readiness, with the DaemonSet's
  desiredNumberScheduled as the open-ended lower bound).
- delete: ordered teardown — delete stamped objects, strip node labels,
  assert removal, then remove the finalizer.
- daemon pod deletion: drop that node from CD status by pod IP, flip
  NotReady (or Degraded) below numNodes.
- stale sweeps: CleanupManager GC + node-label sweeps.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cdcontroller import templates
from tpu_dra_torch.cdcontroller.cleanup import CleanupManager
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.topology.placement import domain_topology
from tpu_dra_torch.infra.workqueue import WorkQueue, default_controller_rate_limiter
from tpu_dra_torch.k8s import (
    ApiClient, COMPUTEDOMAINS, DAEMONSETS, NODES, PODS, RESOURCECLAIMTEMPLATES,
)
from tpu_dra_torch.k8s.client import AlreadyExistsError, ConflictError, NotFoundError
from tpu_dra_torch.k8s.informer import Informer, label_index, uid_index

log = logging.getLogger("tpu_dra_torch.cdcontroller")

reconciles_total = DefaultRegistry.counter(
    "tpu_dra_cd_reconciles_total", "ComputeDomain reconcile passes")
teardowns_total = DefaultRegistry.counter(
    "tpu_dra_cd_teardowns_total", "ComputeDomain teardown completions")
degraded_total = DefaultRegistry.counter(
    "tpu_dra_cd_degraded_total",
    "Ready -> Degraded transitions: a previously-Ready ComputeDomain "
    "lost a member (node death, daemon crash) and says so via "
    "status.statusReason instead of reading as a never-started NotReady")

UID_INDEX = "uid"
CD_LABEL_INDEX = "cd-uid"

# Annotation recording the hash of the template a stamped DaemonSet was
# last written from (kubectl last-applied analog): comparing hashes detects
# every template change — including removed fields — without being fooled
# by server-side defaulting of fields the template never set.
TEMPLATE_HASH_ANNOTATION = "resource.gpu.dev/template-hash"


def _template_hash(spec: Dict) -> str:
    import hashlib
    import json
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


class RetryableError(Exception):
    """Raised to push the reconcile back onto the rate-limited queue."""


class Controller:
    def __init__(self, client: ApiClient, *, namespace: str,
                 image: str = "gpu-dra-driver:latest",
                 log_verbosity: int = 0, feature_gates: str = "",
                 max_nodes_per_clique_domain: int = 64,
                 gc_interval: float = 600.0,
                 daemon_service_account: str = "",
                 open_ready_settle_s: float = 1.0):
        self._client = client
        self._namespace = namespace  # driver namespace (DS + daemon RCT home)
        self._image = image
        self._log_verbosity = log_verbosity
        self._feature_gates = feature_gates
        self._max_nodes = max_nodes_per_clique_domain
        self._daemon_sa = daemon_service_account
        self._queue = WorkQueue(default_controller_rate_limiter())
        self._stop = threading.Event()
        # Open-ended (numNodes==0) readiness settle: uid -> (node-name
        # set, monotonic time of its last change). Expected membership of
        # an open CD lags label-driven daemon summoning, so Ready only
        # flips once the member set has been stable for
        # open_ready_settle_s (late joiners re-arm the window).
        self._open_settle_s = open_ready_settle_s
        self._open_membership: dict = {}

        self.cd_informer = Informer(client, COMPUTEDOMAINS)
        self.cd_informer.add_indexer(UID_INDEX, uid_index)
        self.ds_informer = Informer(
            client, DAEMONSETS, namespace=namespace,
            label_selector=apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        self.ds_informer.add_indexer(
            CD_LABEL_INDEX, label_index(apitypes.COMPUTE_DOMAIN_LABEL_KEY))
        self.rct_informer = Informer(
            client, RESOURCECLAIMTEMPLATES,
            label_selector=apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        self.rct_informer.add_indexer(
            CD_LABEL_INDEX, label_index(apitypes.COMPUTE_DOMAIN_LABEL_KEY))
        self.pod_informer = Informer(
            client, PODS, namespace=namespace,
            label_selector=apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        self.node_informer = Informer(client, NODES)

        self.cd_informer.on_add(lambda obj: self._enqueue_cd_obj(obj))
        self.cd_informer.on_update(lambda _old, new: self._enqueue_cd_obj(new))
        self.cd_informer.on_delete(self._on_cd_deleted)
        self.ds_informer.on_update(self._on_ds_update)
        self.pod_informer.on_delete(self._on_pod_deleted)

        self._cleanup = CleanupManager(
            client=client,
            cd_exists=lambda uid: self._get_cd_by_uid(uid) is not None,
            targets=[
                (DAEMONSETS, namespace),
                (RESOURCECLAIMTEMPLATES, None),
            ],
            interval=gc_interval,
            extra_sweeps=[self._sweep_stale_node_labels])

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for inf in (self.cd_informer, self.ds_informer, self.rct_informer,
                    self.pod_informer, self.node_informer):
            inf.start()
        for inf in (self.cd_informer, self.ds_informer, self.rct_informer,
                    self.pod_informer, self.node_informer):
            inf.wait_for_sync()
        self._queue.run_in_thread()
        self._cleanup.start()

    def stop(self) -> None:
        self._stop.set()
        self._cleanup.stop()
        self._queue.shutdown()
        for inf in (self.cd_informer, self.ds_informer, self.rct_informer,
                    self.pod_informer, self.node_informer):
            inf.stop()

    # -- event handlers (fast, enqueue only) --------------------------------

    def _enqueue_cd_obj(self, cd: Dict) -> None:
        uid = cd["metadata"].get("uid", "")
        if uid:
            self.enqueue(uid)

    def enqueue(self, uid: str) -> None:
        self._queue.enqueue(uid, self._reconcile, key=f"cd/{uid}")

    def _on_cd_deleted(self, cd: Dict) -> None:
        # CD fully gone from the API server: sweep anything left behind.
        uid = cd["metadata"].get("uid", "")
        if uid:
            self._queue.enqueue(uid, self._sweep_after_delete,
                                key=f"gc/{uid}")

    def _on_ds_update(self, _old: Dict, new: Dict) -> None:
        uid = (new["metadata"].get("labels") or {}).get(
            apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        if uid:
            self.enqueue(uid)

    def _on_pod_deleted(self, pod: Dict) -> None:
        uid = (pod["metadata"].get("labels") or {}).get(
            apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        if uid:
            self._queue.enqueue((uid, pod), self._handle_pod_deleted,
                                key=f"pod-del/{uid}/{pod['metadata']['name']}")

    # -- helpers ------------------------------------------------------------

    def _get_cd_by_uid(self, uid: str) -> Optional[Dict]:
        hits = self.cd_informer.get_by_index(UID_INDEX, uid)
        return hits[0] if hits else None

    def _fresh_cd(self, uid: str) -> Optional[Dict]:
        cached = self._get_cd_by_uid(uid)
        if cached is None:
            return None
        meta = cached["metadata"]
        try:
            obj = self._client.get(COMPUTEDOMAINS, meta["name"],
                                   meta.get("namespace"))
        except NotFoundError:
            return None
        return obj if obj["metadata"].get("uid") == uid else None

    # -- reconcile ----------------------------------------------------------

    def _reconcile(self, uid: str) -> None:
        reconciles_total.inc()
        cd = self._fresh_cd(uid)
        if cd is None:
            self._sweep_after_delete(uid)
            return
        if cd["metadata"].get("deletionTimestamp"):
            self._teardown(cd)
            return
        self._ensure_finalizer(cd)
        self._ensure_stamped_objects(cd)
        self._update_readiness(cd)

    def _ensure_finalizer(self, cd: Dict) -> None:
        fins = cd["metadata"].setdefault("finalizers", [])
        if apitypes.COMPUTE_DOMAIN_FINALIZER in fins:
            return
        fins.append(apitypes.COMPUTE_DOMAIN_FINALIZER)
        try:
            updated = self._client.update(COMPUTEDOMAINS, cd)
        except ConflictError as e:
            raise RetryableError(f"finalizer add conflict: {e}") from e
        cd["metadata"] = updated["metadata"]
        self.cd_informer.update_cache(updated)

    def _ensure_stamped_objects(self, cd: Dict) -> None:
        ns = self._namespace
        for build, gvr, obj_ns in (
            (lambda: templates.daemon_claim_template(cd, namespace=ns),
             RESOURCECLAIMTEMPLATES, ns),
            (lambda: templates.daemon_daemonset(
                cd, namespace=ns, image=self._image,
                daemon_claim_template=templates.daemon_object_name(cd),
                log_verbosity=self._log_verbosity,
                feature_gates=self._feature_gates,
                max_nodes_per_clique_domain=self._max_nodes,
                service_account=self._daemon_sa),
             DAEMONSETS, ns),
            (lambda: templates.workload_claim_template(cd),
             RESOURCECLAIMTEMPLATES,
             cd["metadata"].get("namespace", "default")),
        ):
            obj = build()
            if gvr is DAEMONSETS:
                obj["metadata"].setdefault("annotations", {})[
                    TEMPLATE_HASH_ANNOTATION] = _template_hash(obj["spec"])
            if not obj["metadata"].get("name"):
                # spec.channel.resourceClaimTemplate.name unset: without it
                # the create would 422 on every reconcile. The webhook is the
                # real gate; skip + log here so the CD can't wedge the queue.
                log.warning("computedomain %s: no workload RCT name in spec; "
                            "skipping workload template",
                            cd["metadata"].get("name"))
                continue
            try:
                created = self._client.create(gvr, obj, namespace=obj_ns)
            except AlreadyExistsError:
                # DaemonSets get an explicit update path so controller
                # upgrades (new image, gates, max-nodes) reach running
                # CDs; RCT specs are immutable upstream and stay
                # create-only.
                if gvr is DAEMONSETS:
                    self._sync_stamped_daemonset(obj, obj_ns)
                continue
            # Mutation cache: see our own write before the watch lands.
            if gvr is DAEMONSETS:
                self.ds_informer.update_cache(created)
            else:
                self.rct_informer.update_cache(created)

    def _sync_stamped_daemonset(self, want: Dict, ns: str) -> None:
        """Converge an existing per-CD DaemonSet onto the freshly built
        template when the recorded template hash differs (a missing hash —
        pre-upgrade object — converges once and gains the annotation)."""
        name = want["metadata"]["name"]
        try:
            existing = self._client.get(DAEMONSETS, name, ns)
        except NotFoundError:
            raise RetryableError(
                f"daemonset {name} vanished between create-conflict and get")
        want_hash = want["metadata"]["annotations"][TEMPLATE_HASH_ANNOTATION]
        have_hash = (existing["metadata"].get("annotations") or {}).get(
            TEMPLATE_HASH_ANNOTATION)
        if have_hash == want_hash:
            return
        fresh = dict(existing)
        fresh["spec"] = want["spec"]
        fresh["metadata"] = dict(existing["metadata"])
        fresh["metadata"]["annotations"] = dict(
            existing["metadata"].get("annotations") or {},
            **{TEMPLATE_HASH_ANNOTATION: want_hash})
        try:
            updated = self._client.update(DAEMONSETS, fresh, namespace=ns)
        except ConflictError as e:
            raise RetryableError(f"daemonset {name} update conflict: {e}") \
                from e
        self.ds_informer.update_cache(updated)
        log.info("daemonset %s/%s converged onto current template", ns, name)

    def _update_readiness(self, cd: Dict) -> None:
        """Global CD status vs numNodes. With numNodes==0 (the deprecated
        field's semantics) the CD is Ready once every registered daemon is
        ready and at least one is.

        Readiness is counted from cd.status.nodes — the per-node entries
        the cd-daemons themselves maintain — rather than the DaemonSet's
        kubelet-aggregated numberReady. Same convergence signal (each
        daemon's startup probe drives both), one fewer freshness
        dependency, and it is the SAME source the CD plugin's channel
        gate reads (assert_node_ready), so "domain Ready" and "my peers
        are all in the env snapshot" can never disagree. The DaemonSet
        existence check stays: Ready must not flip before the CD's
        infrastructure is stamped."""
        uid = cd["metadata"]["uid"]
        hits = self.ds_informer.get_by_index(CD_LABEL_INDEX, uid)
        if not hits:
            return
        nodes = (cd.get("status") or {}).get("nodes") or []
        ready = sum(1 for n in nodes
                    if n.get("status") == apitypes.COMPUTE_DOMAIN_STATUS_READY)
        num_nodes = (cd.get("spec") or {}).get("numNodes", 0)
        expected_members = num_nodes
        settling = False
        if num_nodes > 0:
            want = (apitypes.COMPUTE_DOMAIN_STATUS_READY
                    if ready >= num_nodes
                    else apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY)
        else:
            # Open-ended CD: every expected daemon ready and at least one.
            # Expected = max(registered, DS desiredNumberScheduled): a
            # scheduled-but-unregistered daemon (pod still pulling) must
            # hold the domain NotReady, or an early channel prepare would
            # snapshot a partial peer env. Harnesses with no kubelet
            # maintaining DS status degrade to the registered count.
            desired = (hits[0].get("status") or {}).get(
                "desiredNumberScheduled", 0)
            expected = max(len(nodes), desired)
            expected_members = expected
            want = (apitypes.COMPUTE_DOMAIN_STATUS_READY
                    if ready > 0 and ready >= expected
                    else apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY)
            if want == apitypes.COMPUTE_DOMAIN_STATUS_READY:
                # Residual race: expected lags label-driven daemon
                # summoning, so the first node's readiness could flip an
                # open-ended domain Ready before later participants have
                # labeled their nodes — the same flake class the strict
                # numNodes gate closes. Hold Ready until the member set
                # has been stable for the settle window; a new member
                # re-arms it (and its status update re-enqueues us).
                sig = frozenset(n.get("name", "") for n in nodes)
                now = time.monotonic()
                prev = self._open_membership.get(uid)
                if prev is None and (cd.get("status") or {}).get(
                        "status") == apitypes.COMPUTE_DOMAIN_STATUS_READY:
                    # Controller restart over an already-Ready domain:
                    # adopt the member set as settled — re-arming here
                    # would flap every stable open-ended CD to NotReady
                    # for a window whose membership never changed.
                    changed_at = now - self._open_settle_s
                    self._open_membership[uid] = (sig, changed_at)
                elif prev is None or prev[0] != sig:
                    self._open_membership[uid] = (sig, now)
                    changed_at = now
                else:
                    changed_at = prev[1]
                remaining = self._open_settle_s - (now - changed_at)
                if remaining > 0:
                    want = apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY
                    settling = True
                    self._queue.enqueue(uid, self._reconcile,
                                        key=f"cd/{uid}", after=remaining)
        # Failure-domain transition: a domain that WAS
        # Ready and no longer meets its readiness bar has LOST something
        # — a member node died, a daemon crash-looped — and the
        # workloads gating on it need to know it is a regression, not a
        # domain that never came up. Ready -> Degraded, with the why in
        # status.statusReason; a Degraded domain stays Degraded until it
        # either recovers (Ready, reason cleared) or is torn down.
        # EXCEPT the settle hold: there every member IS ready — the
        # window exists to absorb growth (a joining member), which is
        # not a loss and must not read (or count) as one.
        reason = None
        if not settling and \
                want == apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY:
            cur = (cd.get("status") or {}).get("status")
            if cur in (apitypes.COMPUTE_DOMAIN_STATUS_READY,
                       apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED):
                want = apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED
                # The pod-delete handler may already have recorded a
                # MORE specific reason (the lost member's name); the
                # periodic readiness pass must not launder it into the
                # generic count.
                reason = ((cd.get("status") or {}).get("statusReason")
                          if cur == apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED
                          else None) or (
                    f"{ready}/{expected_members} members ready "
                    "(member lost or daemon not ready)")
        # NVLink placement observability (gated): how many cliques the
        # registered member set spans and whether it is clique-aligned
        # (one cliqueID, contiguous worker indices). The daemons register
        # cliqueID/index per node, so this is the controller's view of the
        # scheduler's topology-ranked node selection — a Ready domain
        # spanning cliques means collectives will cross the network.
        topo = None
        if (len(nodes) > 1
                and featuregates.enabled(
                    featuregates.TopologyAwareScheduling)):
            topo = domain_topology(nodes)
            if (want == apitypes.COMPUTE_DOMAIN_STATUS_READY
                    and not topo["cliqueAligned"]):
                log.warning(
                    "computedomain %s is Ready but spans %d NVLink cliques "
                    "(members not clique-aligned): inter-node collectives "
                    "will traverse the network", uid, topo["cliques"])
        self._set_cd_status(uid, want, topo=topo, reason=reason)

    def _set_cd_status(self, uid: str, want: str,
                       topo: Optional[Dict] = None,
                       reason: Optional[str] = None) -> None:
        """topo=None means "no topology summary applies" (single-node
        membership, or the gate is off): a previously stamped
        status.topology is REMOVED rather than left stale — the field
        must describe the current member set or not exist. The same
        contract governs `reason` (status.statusReason): recovery to
        Ready republishes cleanly, with no stale degradation note."""
        cd = self._fresh_cd(uid)
        if cd is None:
            return
        status = cd.setdefault("status", {})
        if (status.get("status") == want
                and status.get("topology") == topo
                and status.get("statusReason") == reason):
            return
        newly_degraded = (
            want == apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED
            and status.get("status")
            == apitypes.COMPUTE_DOMAIN_STATUS_READY)
        status["status"] = want
        if topo is not None:
            status["topology"] = topo
        else:
            status.pop("topology", None)
        if reason is not None:
            status["statusReason"] = reason
        else:
            status.pop("statusReason", None)
        status.setdefault("nodes", [])
        try:
            updated = self._client.update_status(COMPUTEDOMAINS, cd)
        except (ConflictError, NotFoundError) as e:
            raise RetryableError(f"status update: {e}") from e
        if newly_degraded:
            # Counted only once the write LANDED: a conflict retries
            # the whole item, and counting before the write would
            # record the same transition per attempt.
            degraded_total.inc()
        self.cd_informer.update_cache(updated)
        log.info("computedomain %s/%s status -> %s",
                 cd["metadata"].get("namespace"), cd["metadata"]["name"], want)

    # -- daemon pod deletions ----------------------------------------------

    def _handle_pod_deleted(self, item) -> None:
        uid, pod = item
        cd = self._fresh_cd(uid)
        if cd is None:
            return
        pod_ip = (pod.get("status") or {}).get("podIP", "")
        if not pod_ip:
            return
        # Stale-event guard: with hostNetwork the replacement daemon pod
        # reuses the node IP, and its registration must not be stripped by
        # the queued deletion of its predecessor.
        for live in self.pod_informer.lister.list():
            if (live["metadata"]["name"] != pod["metadata"]["name"]
                    and (live["metadata"].get("labels") or {}).get(
                        apitypes.COMPUTE_DOMAIN_LABEL_KEY) == uid
                    and (live.get("status") or {}).get("podIP") == pod_ip):
                return
        nodes = (cd.get("status") or {}).get("nodes") or []
        kept = [n for n in nodes if n.get("ipAddress") != pod_ip]
        if len(kept) == len(nodes):
            return
        # Injection site: the member-loss handling itself fails (status
        # write refused) — the keyed queue item must retry until the
        # loss is recorded; a CD must never sit Ready with a dead member
        # because the handler gave up.
        FAULTS.check("cd.member_loss", cd=uid, pod_ip=pod_ip)
        lost = sorted(n.get("name", "?") for n in nodes if n not in kept)
        cd.setdefault("status", {})["nodes"] = kept
        num_nodes = (cd.get("spec") or {}).get("numNodes", 0)
        short = ((num_nodes and len(kept) < num_nodes)
                 or (not num_nodes and not kept))
        newly_degraded = False
        if short:
            was = cd["status"].get("status")
            if was in (apitypes.COMPUTE_DOMAIN_STATUS_READY,
                       apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED):
                # Ready -> Degraded with the member named: member loss
                # mid-job reads as a regression with a reason, never a
                # wedged CD still claiming Ready.
                newly_degraded = \
                    was == apitypes.COMPUTE_DOMAIN_STATUS_READY
                cd["status"]["status"] = \
                    apitypes.COMPUTE_DOMAIN_STATUS_DEGRADED
            else:
                cd["status"]["status"] = \
                    apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY
            cd["status"]["statusReason"] = (
                f"member node lost: {', '.join(lost)} "
                f"({len(kept)}/{num_nodes or len(nodes)} members remain)")
        try:
            updated = self._client.update_status(COMPUTEDOMAINS, cd)
        except (ConflictError, NotFoundError) as e:
            raise RetryableError(f"pod-delete status update: {e}") from e
        if newly_degraded:
            # After the write, not before: a conflict re-runs the keyed
            # item and would double-count the same transition.
            degraded_total.inc()
        self.cd_informer.update_cache(updated)
        if short:
            log.warning("computedomain %s degraded: %s", uid,
                        cd["status"]["statusReason"])

    # -- teardown -----------------------------------------------------------

    def _teardown(self, cd: Dict) -> None:
        """Ordered teardown: stamped objects, node labels, assert removal,
        then the finalizer."""
        uid = cd["metadata"]["uid"]
        ns = self._namespace
        # Delete by CD-UID label, not by current spec names: a renamed
        # workload RCT would otherwise survive with the label and wedge the
        # leftover assertion forever.
        selector = f"{apitypes.COMPUTE_DOMAIN_LABEL_KEY}={uid}"
        for gvr, gvr_ns in ((RESOURCECLAIMTEMPLATES, None), (DAEMONSETS, ns)):
            for obj in self._client.list(gvr, namespace=gvr_ns,
                                         label_selector=selector):
                self._client.delete(gvr, obj["metadata"]["name"],
                                    obj["metadata"].get("namespace"))
        self._remove_node_labels(uid)

        # Assert removal before dropping the finalizer.
        leftovers: List[str] = []
        for gvr, gvr_ns in ((DAEMONSETS, ns), (RESOURCECLAIMTEMPLATES, None)):
            for obj in self._client.list(gvr, namespace=gvr_ns,
                                         label_selector=selector):
                leftovers.append(f"{gvr.plural}/{obj['metadata']['name']}")
        if leftovers:
            raise RetryableError(f"teardown of {uid}: waiting on {leftovers}")

        fins = cd["metadata"].get("finalizers") or []
        if apitypes.COMPUTE_DOMAIN_FINALIZER in fins:
            fins.remove(apitypes.COMPUTE_DOMAIN_FINALIZER)
            cd["metadata"]["finalizers"] = fins
            try:
                self._client.update(COMPUTEDOMAINS, cd)
            except ConflictError as e:
                raise RetryableError(f"finalizer removal conflict: {e}") from e
            except NotFoundError:
                pass
        teardowns_total.inc()
        log.info("computedomain %s torn down", uid)

    # -- node labels --------------------------------------------------------

    def _remove_node_labels(self, uid: str) -> None:
        """Strip resource.gpu.dev/computeDomain=<uid> from every node."""
        for node in self.node_informer.lister.list():
            labels = node["metadata"].get("labels") or {}
            if labels.get(apitypes.COMPUTE_DOMAIN_LABEL_KEY) != uid:
                continue
            try:
                self._client.patch(
                    NODES, node["metadata"]["name"],
                    {"metadata": {"labels": {
                        apitypes.COMPUTE_DOMAIN_LABEL_KEY: None}}})
            except NotFoundError:
                pass

    def _sweep_stale_node_labels(self) -> None:
        """Periodic stale-label sweep: labels pointing at CDs that no
        longer exist are removed."""
        for node in self._client.list(NODES):
            labels = node["metadata"].get("labels") or {}
            uid = labels.get(apitypes.COMPUTE_DOMAIN_LABEL_KEY)
            if uid and self._get_cd_by_uid(uid) is None:
                try:
                    self._client.patch(
                        NODES, node["metadata"]["name"],
                        {"metadata": {"labels": {
                            apitypes.COMPUTE_DOMAIN_LABEL_KEY: None}}})
                except NotFoundError:
                    pass

    def _sweep_after_delete(self, uid: str) -> None:
        self._remove_node_labels(uid)
        self._cleanup.collect_uid(uid)
        self._open_membership.pop(uid, None)
