"""Daemon-side ComputeDomain registration and membership tracking
(counterpart of tpu_dra/cddaemon/computedomain.py).

``ensure_node_info`` inserts {name, ip, cliqueID, index} into the CD
status with gap-filling index allocation *within the node's clique
group* (stable DNS names derive from the index), bounded by
max_nodes; node-set changes are deduped and pushed over a latest-wins
queue; the node removes itself from the status on shutdown.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.infra.trace import ENV_TRACEPARENT, TRACER
from tpu_dra_torch.infra.workqueue import default_cd_daemon_rate_limiter
from tpu_dra_torch.k8s import ApiClient, COMPUTEDOMAINS
from tpu_dra_torch.k8s.client import ConflictError, NotFoundError
from tpu_dra_torch.k8s.informer import Informer

log = logging.getLogger("tpu_dra_torch.cddaemon.cd")

# A membership snapshot: tuple of (name, ip, clique_id, index) per node.
NodeSet = Tuple[Tuple[str, str, str, int], ...]


class IndexAllocationError(Exception):
    pass


def allocate_index(nodes: List[Dict], clique_id: str, max_nodes: int) -> int:
    """Smallest free index within the clique group. Gap-filling keeps DNS
    names stable when members churn."""
    used = {n.get("index", 0) for n in nodes
            if n.get("cliqueID", "") == clique_id}
    for candidate in range(max_nodes):
        if candidate not in used:
            return candidate
    raise IndexAllocationError(
        f"clique {clique_id!r} is full ({max_nodes} nodes)")


class ComputeDomainManager:
    def __init__(self, client: ApiClient, *, cd_name: str, cd_namespace: str,
                 cd_uid: str, node_name: str, node_ip: str, clique_id: str,
                 max_nodes: int = 64):
        self._client = client
        self._cd_name = cd_name
        self._cd_ns = cd_namespace
        self._cd_uid = cd_uid
        self._node_name = node_name
        self._node_ip = node_ip
        self._clique_id = clique_id
        self._max_nodes = max_nodes
        self.index: Optional[int] = None
        # Deduped membership updates; maxsize=1 with latest-wins put.
        self.updates: "queue.Queue[NodeSet]" = queue.Queue(maxsize=1)
        self._last_set: Optional[NodeSet] = None
        self._lock = threading.Lock()
        # Name-filtered informer.
        self.informer = Informer(
            client, COMPUTEDOMAINS, namespace=cd_namespace,
            field_filter=lambda obj: (obj.get("metadata", {}).get("name")
                                      == cd_name))
        self.informer.on_add(self._on_change)
        self.informer.on_update(lambda _old, new: self._on_change(new))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.informer.start()
        self.informer.wait_for_sync()

    def stop(self) -> None:
        self.informer.stop()

    # -- registration -------------------------------------------------------

    def _get_cd(self) -> Dict:
        cd = self._client.get(COMPUTEDOMAINS, self._cd_name, self._cd_ns)
        if self._cd_uid and cd["metadata"].get("uid") != self._cd_uid:
            raise NotFoundError(
                f"computedomain {self._cd_name} uid changed")
        return cd

    def ensure_node_info(self, retries: int = 20) -> int:
        """Insert/refresh this node in the CD status; returns the stable
        index. Conflict-retried with jittered exponential backoff: at
        fleet startup up to max_nodes daemons race writes on one status
        object, and a tight loop exhausts its budget and crashes the pod."""
        backoff = default_cd_daemon_rate_limiter()
        for _ in range(retries):
            cd = self._get_cd()
            status = cd.setdefault("status", {})
            status.setdefault(
                "status", apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY)
            nodes = status.setdefault("nodes", [])
            mine = next((n for n in nodes
                         if n.get("name") == self._node_name), None)
            if mine is not None:
                if (mine.get("ipAddress") == self._node_ip
                        and mine.get("cliqueID") == self._clique_id):
                    self.index = mine.get("index", 0)
                    return self.index
                mine["ipAddress"] = self._node_ip
                if mine.get("cliqueID") != self._clique_id:
                    # Moved into a different clique: the old index may
                    # collide inside the new group — reallocate there.
                    mine["cliqueID"] = self._clique_id
                    mine["index"] = allocate_index(
                        [n for n in nodes if n is not mine],
                        self._clique_id, self._max_nodes)
                index = mine.get("index", 0)
            else:
                index = allocate_index(nodes, self._clique_id, self._max_nodes)
                nodes.append({
                    "name": self._node_name,
                    "ipAddress": self._node_ip,
                    "cliqueID": self._clique_id,
                    "index": index,
                    "status": apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY,
                })
            try:
                self._client.update_status(COMPUTEDOMAINS, cd)
                self.index = index
                return index
            except ConflictError:
                time.sleep(backoff.when(0))
                continue
        raise ConflictError(
            f"could not register node {self._node_name} after {retries} tries")

    def remove_node_info(self, retries: int = 20) -> None:
        """Self-removal on shutdown."""
        backoff = default_cd_daemon_rate_limiter()
        for _ in range(retries):
            try:
                cd = self._get_cd()
            except NotFoundError:
                return
            nodes = (cd.get("status") or {}).get("nodes") or []
            kept = [n for n in nodes if n.get("name") != self._node_name]
            if len(kept) == len(nodes):
                return
            cd["status"]["nodes"] = kept
            try:
                self._client.update_status(COMPUTEDOMAINS, cd)
                return
            except ConflictError:
                time.sleep(backoff.when(0))
                continue
        # A silently stale registration holds the index and keeps the node
        # counted Ready; surface the failure to the caller.
        raise ConflictError(
            f"could not deregister node {self._node_name} after "
            f"{retries} tries")

    def set_node_status(self, ready: bool, retries: int = 20) -> None:
        """Mirror local daemon readiness into the per-node status field."""
        want = (apitypes.COMPUTE_DOMAIN_STATUS_READY if ready
                else apitypes.COMPUTE_DOMAIN_STATUS_NOT_READY)
        backoff = default_cd_daemon_rate_limiter()
        for _ in range(retries):
            try:
                cd = self._get_cd()
            except NotFoundError:
                return
            nodes = (cd.get("status") or {}).get("nodes") or []
            mine = next((n for n in nodes
                         if n.get("name") == self._node_name), None)
            if mine is None or mine.get("status") == want:
                return
            mine["status"] = want
            try:
                self._client.update_status(COMPUTEDOMAINS, cd)
                if ready:
                    # Trace-loop closure: a daemon launched from a CD
                    # claim's CDI env carries the claim's
                    # TPU_DRA_TRACEPARENT — the readiness mirror is the
                    # claim's last control-plane hop, landed as a closed
                    # ``cd.ready`` span on the same trace. No env, no
                    # span (in-sim daemons run without the claim env).
                    tp = os.environ.get(ENV_TRACEPARENT)
                    if tp:
                        TRACER.record_span(
                            "cd.ready", 0.0, traceparent=tp,
                            attributes={"node": self._node_name})
                return
            except ConflictError:
                time.sleep(backoff.when(0))
                continue
        # Surface exhaustion so the caller retries (a silent return would
        # let the readiness loop record the mirror as done).
        raise ConflictError(
            f"could not mirror node status for {self._node_name} "
            f"after {retries} tries")

    # -- membership updates -------------------------------------------------

    def _on_change(self, cd: Dict) -> None:
        nodes = (cd.get("status") or {}).get("nodes") or []
        node_set: NodeSet = tuple(sorted(
            (n.get("name", ""), n.get("ipAddress", ""),
             n.get("cliqueID", ""), n.get("index", 0))
            for n in nodes))
        with self._lock:
            if node_set == self._last_set:
                return
            self._last_set = node_set
        # Latest wins: drop a stale queued snapshot if the consumer lags.
        while True:
            try:
                self.updates.put_nowait(node_set)
                return
            except queue.Full:
                try:
                    self.updates.get_nowait()
                except queue.Empty:
                    pass

    def clique_peers(self, node_set: NodeSet) -> List[Tuple[int, str]]:
        """[(index, ip)] of members in this node's clique group — the set
        that rendezvous together; other cliques are peers over the
        network."""
        return [(index, ip) for (_name, ip, clique_id, index) in node_set
                if clique_id == self._clique_id]
