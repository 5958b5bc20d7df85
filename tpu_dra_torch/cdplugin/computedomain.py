"""Node-side ComputeDomain operations for the CD kubelet plugin
(counterpart of tpu_dra/cdplugin/computedomain.py).

Namespace assertion (a permanent error), node labeling (*this* is what
pulls the per-CD DaemonSet pod onto the node), the readiness assertion
(retried inside the prepare envelope), the workload's rendezvous env, and
the daemon config-dir lifecycle.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cddaemon.dnsnames import stable_name
from tpu_dra_torch.k8s import ApiClient, COMPUTEDOMAINS, NODES
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.k8s.informer import Informer, uid_index

log = logging.getLogger("tpu_dra_torch.cdplugin")

UID_INDEX = "uid"

# Default port of the domain's rendezvous (the TCPStore the workload's
# rank 0 serves at MASTER_ADDR): the reference's coordinator port. The
# CD plugin takes another with --coordinator-port.
COORDINATOR_PORT = 8476


class PermanentError(Exception):
    """Not retryable inside the prepare envelope."""


class ComputeDomainManager:
    def __init__(self, client: ApiClient, *, node_name: str,
                 driver_plugin_dir: str,
                 coordinator_port: int = COORDINATOR_PORT):
        self._client = client
        self._node_name = node_name
        self._coordinator_port = coordinator_port
        self._domains_root = os.path.join(driver_plugin_dir, "domains")
        self.informer = Informer(client, COMPUTEDOMAINS)
        self.informer.add_indexer(UID_INDEX, uid_index)
        # Change signal for readiness waiters (wait_for_change): a CD
        # add/update bumps that CD's generation and wakes sleepers, so
        # the readiness dance converges at watch-event latency instead of
        # the next poll tick. Generations are PER CD UID: a node with a
        # prepare blocked on CD X must not pay a retry attempt (claim
        # fetch + prepare pass) for every unrelated CD churning status.
        self._change_cond = threading.Condition()
        self._change_gens: Dict[str, int] = {}
        self._membership_ts: Dict[str, float] = {}
        self._last_membership: Dict[str, object] = {}
        self.informer.on_add(lambda obj: self._bump(obj))
        self.informer.on_update(lambda old, new: self._bump(new, old=old))
        # Deleted CDs drop their generation entry (bounded map in a
        # node-lifetime daemon) — with a final bump so a waiter blocked
        # on a CD that just vanished re-checks and fails fast.
        self.informer.on_delete(lambda obj: self._bump(obj, drop=True))

    def _bump(self, obj: Dict, drop: bool = False,
              old: Optional[Dict] = None) -> None:
        uid = (obj.get("metadata") or {}).get("uid", "")
        with self._change_cond:
            if drop:
                self._change_gens.pop(uid, None)
                self._membership_ts.pop(uid, None)
                self._last_membership.pop(uid, None)
            else:
                self._change_gens[uid] = self._change_gens.get(uid, 0) + 1
                # Membership compared against OUR OWN last-seen value, not
                # the handler's `old`: watch relists replay adds for every
                # cached object (old=None), and stamping on those would
                # re-arm the settle grace cluster-wide on each reconnect.
                m = self._membership(obj)
                if uid not in self._last_membership \
                        or m != self._last_membership[uid]:
                    # Membership progress (a node registered / flipped):
                    # timestamped so the settle grace can distinguish "the
                    # domain is still forming" from "nothing is coming".
                    self._last_membership[uid] = m
                    self._membership_ts[uid] = time.monotonic()
            self._change_cond.notify_all()

    @staticmethod
    def _membership(obj: Optional[Dict]):
        if not obj:
            return None
        return sorted((n.get("name", ""), n.get("status", ""))
                      for n in (obj.get("status") or {}).get("nodes") or [])

    def last_membership_change(self, cd_uid: str, default: float = 0.0
                               ) -> float:
        with self._change_cond:
            return self._membership_ts.get(cd_uid, default)

    def change_gen(self, cd_uid: str) -> int:
        with self._change_cond:
            return self._change_gens.get(cd_uid, 0)

    def wait_for_change(self, cd_uid: str, seen_gen: Optional[int],
                        timeout: float) -> int:
        """Block until an event for THIS CD lands after `seen_gen` (or
        timeout). Returns the current generation. Capture change_gen()
        BEFORE checking state: an event between check and wait then
        returns immediately instead of being missed. seen_gen=None (uid
        not known before the first failure) waits from the CURRENT
        generation — the only rung where an event landing mid-attempt can
        be slept through, bounded by the ladder's 5ms first delay.

        Loops on the shared condition: notify_all fires for EVERY CD's
        events, and a spurious wake must not be reported as a change —
        the caller would pay a full retry attempt per unrelated event."""
        deadline = time.monotonic() + timeout
        with self._change_cond:
            if seen_gen is None:
                seen_gen = self._change_gens.get(cd_uid, 0)
            while self._change_gens.get(cd_uid, 0) == seen_gen:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._change_cond.wait(remaining)
            return self._change_gens.get(cd_uid, 0)

    def start(self) -> None:
        self.informer.start()
        self.informer.wait_for_sync()

    def stop(self) -> None:
        self.informer.stop()

    # -- lookups ------------------------------------------------------------

    def get_by_uid(self, uid: str) -> Optional[Dict]:
        hits = self.informer.get_by_index(UID_INDEX, uid)
        if hits:
            return hits[0]
        # Fall back to a live list: the claim may arrive before the watch.
        for cd in self._client.list(COMPUTEDOMAINS):
            if cd["metadata"].get("uid") == uid:
                self.informer.update_cache(cd)
                return cd
        return None

    # -- assertions -----------------------------------------------------------

    def assert_namespace(self, cd_uid: str, claim_namespace: str) -> Dict:
        """The workload claim must live in the CD's namespace; a mismatch is
        permanent — retrying cannot fix a cross-namespace reference."""
        cd = self.get_by_uid(cd_uid)
        if cd is None:
            raise RetryableNotReady(f"computedomain {cd_uid} not found (yet)",
                                    cd_uid=cd_uid)
        if cd["metadata"].get("namespace") != claim_namespace:
            raise PermanentError(
                f"claim namespace {claim_namespace!r} does not match "
                f"computedomain namespace {cd['metadata'].get('namespace')!r}")
        return cd

    def assert_node_ready(self, cd_uid: str,
                          require_domain_ready: bool = True) -> Dict:
        """Block the prepare until the CD reports *this* node Ready — and,
        while require_domain_ready, the domain itself Ready (the
        controller flips that only once the expected membership is ready,
        controller._update_readiness).

        The domain-level gate matters here where it does not for an IMEX
        channel (a composition-independent char-dev): the workload env
        snapshots the CD's node list (GPU_WORKER_HOSTNAMES, NNODES, the
        multi-clique block) — preparing as soon as the local daemon was
        up could inject a peer list missing nodes that had not
        registered yet.

        The caller BOUNDS the strict gate (device_state's settle grace):
        daemons are summoned by channel prepares' own node labels, so a
        workload running fewer pods than spec.numNodes would never flip
        the domain Ready — an unconditional gate would wedge it in
        ContainerCreating forever. After the grace the prepare degrades
        to this-node-Ready with a best-effort env snapshot (the
        pre-domain-gate behavior).
        """
        cd = self.get_by_uid(cd_uid)
        if cd is None:
            raise RetryableNotReady(f"computedomain {cd_uid} not found",
                                    cd_uid=cd_uid)
        nodes = (cd.get("status") or {}).get("nodes") or []
        mine = next((n for n in nodes
                     if n.get("name") == self._node_name), None)
        if mine is None:
            raise RetryableNotReady(
                f"node {self._node_name} not yet registered in cd {cd_uid}",
                cd_uid=cd_uid)
        if mine.get("status") != apitypes.COMPUTE_DOMAIN_STATUS_READY:
            raise RetryableNotReady(
                f"node {self._node_name} not Ready in cd {cd_uid}",
                cd_uid=cd_uid)
        if (require_domain_ready
                and (cd.get("status") or {}).get("status")
                != apitypes.COMPUTE_DOMAIN_STATUS_READY):
            raise RetryableNotReady(
                f"cd {cd_uid} membership still settling (domain not Ready)",
                cd_uid=cd_uid)
        return cd

    # -- node labeling ----------------------------------------------------------

    def add_node_label(self, cd_uid: str) -> None:
        node = self._client.get(NODES, self._node_name)
        labels = node["metadata"].get("labels") or {}
        current = labels.get(apitypes.COMPUTE_DOMAIN_LABEL_KEY)
        if current == cd_uid:
            return
        if current and self.get_by_uid(current) is not None:
            # One CD at a time per node: its GPUs are exclusive hardware.
            raise PermanentError(
                f"node {self._node_name} already belongs to computedomain "
                f"{current}")
        self._client.patch(NODES, self._node_name, {"metadata": {"labels": {
            apitypes.COMPUTE_DOMAIN_LABEL_KEY: cd_uid}}})

    def remove_node_label(self, cd_uid: str) -> None:
        try:
            node = self._client.get(NODES, self._node_name)
        except NotFoundError:
            return
        labels = node["metadata"].get("labels") or {}
        if labels.get(apitypes.COMPUTE_DOMAIN_LABEL_KEY) != cd_uid:
            return
        self._client.patch(NODES, self._node_name, {"metadata": {"labels": {
            apitypes.COMPUTE_DOMAIN_LABEL_KEY: None}}})

    # -- rendezvous env ---------------------------------------------------------

    def workload_env(self, cd: Dict, channel_ids: List[int],
                     allocation_mode: str) -> Dict[str, str]:
        """Env a workload container needs to run collectives over the
        domain: worker identity and peer list within this node's clique,
        the clique's coordinator, the multi-clique block for a domain
        that spans cliques, and the torch.distributed rendezvous.

        ``MASTER_ADDR``/``MASTER_PORT`` name ONE store for the whole
        domain, at the global coordinator (index 0 of the first clique in
        sorted order, the reference's multi-slice coordinator), and
        ``NODE_RANK``/``NNODES`` place this node in the (clique, index)
        order over every node of the domain. An env is per container,
        not per rank: the launcher derives each rank's RANK and
        WORLD_SIZE from these and the claim's GPUs."""
        nodes = (cd.get("status") or {}).get("nodes") or []
        mine = next(n for n in nodes if n.get("name") == self._node_name)
        my_clique = mine.get("cliqueID", "")
        group = sorted(((n.get("index", 0), n) for n in nodes
                        if n.get("cliqueID", "") == my_clique),
                       key=lambda pair: pair[0])
        peers = [stable_name(i) for i, _n in group]
        coordinator = next((n for i, n in group if i == 0), None)
        clique_ids = sorted({n.get("cliqueID", "") for n in nodes})
        ordered = sorted(nodes, key=lambda n: (n.get("cliqueID", ""),
                                               n.get("index", 0)))
        # Global coordinator for the cross-clique rendezvous: every
        # clique must agree on ONE address — the index-0 member of the
        # first clique in sorted order, not the per-clique coordinator.
        global_coord = next(
            (n for n in ordered
             if n.get("cliqueID", "") == clique_ids[0]
             and n.get("index", 0) == 0), None) if clique_ids else None

        port = self._coordinator_port
        env = {
            "COMPUTE_DOMAIN_UUID": cd["metadata"].get("uid", ""),
            "COMPUTE_DOMAIN_NAME": cd["metadata"].get("name", ""),
            "COMPUTE_DOMAIN_NAMESPACE": cd["metadata"].get("namespace", ""),
            "GPU_CLIQUE_ID": my_clique,
            "GPU_WORKER_ID": str(mine.get("index", 0)),
            "GPU_WORKER_HOSTNAMES": ",".join(peers),
            "GPU_PROCESS_COUNT": str(len(group)),
            "NODE_RANK": str(ordered.index(mine)),
            "NNODES": str(len(nodes)),
        }
        if coordinator is not None:
            env["GPU_COORDINATOR_ADDRESS"] = (
                f"{coordinator.get('ipAddress', '')}:{port}")
        if global_coord is not None:
            env["MASTER_ADDR"] = global_coord.get("ipAddress", "")
            env["MASTER_PORT"] = str(port)
        # Allocation -> mesh handoff: surface the controller-stamped
        # clique-alignment verdict (status.topology, cdcontroller) so a
        # workload's mesh builder can tell a clique-aligned domain
        # (NVLink end to end) from one stitched across cliques (network
        # hops) without an API-server round trip.
        topo = (cd.get("status") or {}).get("topology") or {}
        if topo:
            env["GPU_CD_CLIQUES"] = str(topo.get("cliques", 1))
            env["GPU_CD_CLIQUE_ALIGNED"] = (
                "true" if topo.get("cliqueAligned") else "false")
        if len(clique_ids) > 1:
            # A domain across cliques: they talk over the network.
            env["GPU_NUM_CLIQUES"] = str(len(clique_ids))
            env["GPU_CLIQUE_INDEX"] = str(clique_ids.index(my_clique))
            if global_coord is not None:
                env["GPU_CLIQUES_COORDINATOR_ADDRESS"] = (
                    f"{global_coord.get('ipAddress', '')}:{port}")
        if allocation_mode == apitypes.ALLOCATION_MODE_ALL:
            env["GPU_CD_CHANNELS"] = "all"
        else:
            env["GPU_CD_CHANNELS"] = ",".join(str(c) for c in channel_ids)
        return env

    # -- daemon config dirs -----------------------------------------------------

    def domain_dir(self, cd_uid: str) -> str:
        return os.path.join(self._domains_root, cd_uid)

    def prepare_daemon_dir(self, cd: Dict, clique_id: str) -> str:
        """Per-CD config dir handed to the daemon pod."""
        path = self.domain_dir(cd["metadata"]["uid"])
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "domain.env"), "w") as f:
            f.write(f"COMPUTE_DOMAIN_UUID={cd['metadata'].get('uid', '')}\n"
                    f"COMPUTE_DOMAIN_NAME={cd['metadata'].get('name', '')}\n"
                    f"COMPUTE_DOMAIN_NAMESPACE="
                    f"{cd['metadata'].get('namespace', '')}\n"
                    f"GPU_CLIQUE_ID={clique_id}\n")
        return path

    def gc_domain_dirs(self) -> List[str]:
        """Remove config dirs of CDs that no longer exist. Returns the
        removed uids."""
        removed = []
        if not os.path.isdir(self._domains_root):
            return removed
        for uid in os.listdir(self._domains_root):
            if self.get_by_uid(uid) is None:
                shutil.rmtree(os.path.join(self._domains_root, uid),
                              ignore_errors=True)
                removed.append(uid)
        return removed


class RetryableNotReady(Exception):
    """Retried by the prepare envelope until the 45s budget runs out.
    Carries the CD uid (when known) so the retry can sleep on that CD's
    change signal instead of the global ladder."""

    def __init__(self, msg: str, cd_uid: str = ""):
        super().__init__(msg)
        self.cd_uid = cd_uid
