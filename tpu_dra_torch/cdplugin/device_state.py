"""CD plugin device state: checkpointed channel/daemon prepare
(counterpart of tpu_dra/cdplugin/device_state.py).

Channel prepare: namespace assert (permanent), node label (pulls the
daemon pod here), block until this node is Ready in the CD status, then
inject the rendezvous env via CDI. Daemon prepare: per-CD config dir +
identity env. Channel exclusivity: a checkpoint-based node-local
assertion that a channel is not already held by a different completed
claim.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from tpu_dra_torch.api import scheme as apischeme
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.cdplugin import deviceinfo
from tpu_dra_torch.infra.trace import (
    ENV_TRACEPARENT, TRACEPARENT_ANNOTATION, TRACER,
)
from tpu_dra_torch.cdplugin.computedomain import (
    ComputeDomainManager, PermanentError, RetryableNotReady,
)
from tpu_dra_torch.kubeletplugin.server import PreparedDevice, PrepareResult
from tpu_dra_torch.gpuplugin.checkpoint import (
    Checkpoint, CheckpointManager, PREPARE_COMPLETED, PREPARE_STARTED,
    PreparedClaim,
)

log = logging.getLogger("tpu_dra_torch.cdplugin")


class DeviceState:
    def __init__(self, *, cd_manager: ComputeDomainManager, cdi: CDIHandler,
                 checkpoints: CheckpointManager, driver_name: str,
                 node_name: str, clique_id: str):
        self._cd = cd_manager
        self._cdi = cdi
        self._ckpt_mgr = checkpoints
        self._driver_name = driver_name
        self._node_name = node_name
        self._clique_id = clique_id
        self._lock = threading.Lock()
        # Serializes every checkpoint-read→label-write sequence: unprepare()
        # end-to-end, and prepare's checkpoint-record + add_node_label pair.
        # still_used is computed from the checkpoint and then acted on
        # outside self._lock (label removal is a network call); without this
        # mutex, (a) two concurrent unprepares of the last two channel
        # claims of one CD can each see the other still checkpointed, both
        # skip remove_node_label, and the label leaks with no kubelet retry
        # left; (b) an in-flight unprepare that computed still_used == {}
        # can remove the label *after* a concurrent prepare checkpointed a
        # new claim and added it. One node-global lock is deliberate (the
        # GPU plugin holds a per-node flock across entire prepare/unprepare
        # calls for the same reason); the held section here is one
        # checkpoint read plus at most one label API call, and a hung API
        # server stalls kubelet's envelope either way. Ordering:
        # _label_lock is always taken outside self._lock.
        self._label_lock = threading.Lock()
        # (first, last) attempt timestamps per claim (the domain-settle
        # grace in _prepare_channel); in-memory only — a restart just
        # re-grants the grace, which is the safe direction. Entries drop
        # on success and on unprepare.
        self._first_attempt: Dict[str, tuple] = {}
        self._checkpoint = self._ckpt_mgr.load_or_init()

    # ------------------------------------------------------------------
    # Prepare
    # ------------------------------------------------------------------

    # How long a channel prepare insists on DOMAIN-level Ready before
    # degrading to this-node-Ready with a best-effort env snapshot (see
    # ComputeDomainManager.assert_node_ready). Generous vs the measured
    # ~0.1s convergence; a fraction of kubelet's retry horizon.
    DOMAIN_SETTLE_GRACE_S = 10.0
    # Attempts further apart than this start a NEW grace window (a fresh
    # kubelet envelope after a long gap re-arms the strict gate; within
    # one envelope the retry ladder never pauses longer than ~7.5s).
    ATTEMPT_GAP_RESET_S = 15.0

    def wait_cd_change(self, cd_uid: str, seen_gen, timeout: float) -> int:
        """See ComputeDomainManager.wait_for_change (event-driven retry
        wake, keyed by CD uid)."""
        return self._cd.wait_for_change(cd_uid, seen_gen, timeout)

    def prepare(self, claim: Dict) -> PrepareResult:
        """May raise RetryableNotReady (the driver retries inside its 45s
        envelope) or PermanentError (short-circuits)."""
        uid = claim["metadata"]["uid"]
        with self._lock:
            existing = self._checkpoint.claims.get(uid)
            if existing is not None and existing.state == PREPARE_COMPLETED \
                    and self._cdi.claim_spec_exists(uid):
                # Same gate as the GPU plugin's fast path: a crash can
                # persist the terminal checkpoint sync yet lose the claim
                # spec's never-synced rename — vouching for the vanished
                # file would fail container creation forever. Fall
                # through and re-run the prepare (idempotent) to rewrite
                # it.
                return PrepareResult(devices=[
                    self._rehydrate(r) for r in existing.devices])

        allocation = ((claim.get("status") or {}).get("allocation") or {})
        results = [r for r in (allocation.get("devices") or {})
                   .get("results", [])
                   if r.get("driver") == self._driver_name]
        if not results:
            raise PermanentError("claim has no allocation results for this driver")

        config = self._decode_config(allocation, results)
        if isinstance(config, apitypes.ComputeDomainChannelConfig):
            return self._prepare_channel(claim, results, config)
        if isinstance(config, apitypes.ComputeDomainDaemonConfig):
            return self._prepare_daemon(claim, results, config)
        raise PermanentError(
            f"unsupported config kind {type(config).__name__}")

    def _decode_config(self, allocation: Dict, results: List[Dict]):
        entries = (allocation.get("devices") or {}).get("config", []) or []
        for entry in entries:
            opaque = entry.get("opaque") or {}
            if opaque.get("driver") != self._driver_name:
                continue
            try:
                cfg = apischeme.StrictDecoder.decode(
                    opaque.get("parameters", {}))
            except apischeme.DecodeError as e:
                raise PermanentError(f"invalid opaque config: {e}") from e
            cfg.normalize()
            cfg.validate()
            return cfg
        raise PermanentError(
            "claim carries no ComputeDomain opaque config for this driver")

    # -- channel (workload) claims ------------------------------------------

    def _prepare_channel(self, claim: Dict, results: List[Dict],
                         config: apitypes.ComputeDomainChannelConfig
                         ) -> PrepareResult:
        uid = claim["metadata"]["uid"]
        ns = claim["metadata"].get("namespace", "")
        cd = self._cd.assert_namespace(config.domain_id, ns)

        channel_ids = [deviceinfo.parse_channel_id(r["device"])
                       for r in results]
        # _label_lock spans checkpoint-record + add_node_label so a
        # concurrent unprepare of this CD's last old claim cannot compute
        # still_used == {} before this claim is recorded and then strip the
        # label after we add it (see __init__). The long readiness wait
        # below is NOT under the lock.
        with self._label_lock:
            with self._lock:
                self._assert_channels_free_locked(uid, channel_ids)
                # Record intent before side effects (crash consistency).
                self._checkpoint.claims[uid] = PreparedClaim(
                    uid=uid, state=PREPARE_STARTED,
                    name=claim["metadata"].get("name", ""), namespace=ns)
                self._checkpoint.claims[uid].devices = [{
                    "type": deviceinfo.DEVICE_TYPE_CHANNEL,
                    "device": r["device"],
                    "request": r.get("request", ""),
                    "channel_id": deviceinfo.parse_channel_id(r["device"]),
                    "cd_uid": config.domain_id,
                    "pool": self._node_name,
                    "cdi_ids": [self._cdi.get_claim_device(uid)],
                } for r in results]
                # Transient mid-prepare record: side slot (the primary
                # keeps only settled state for downgrade readers — see
                # gpuplugin/checkpoint.py CheckpointManager).
                self._ckpt_mgr.store(self._checkpoint, intent=True)

            # Label first (this is what summons the daemon pod), then wait.
            self._cd.add_node_label(config.domain_id)
        # Strict domain-Ready gate while the domain is SETTLING, so a
        # workload smaller than spec.numNodes (whose labels will never
        # summon enough daemons to flip the domain) degrades to the
        # node-Ready gate instead of wedging (assert_node_ready doc).
        # "Settling" = within the grace of this claim's first attempt OR
        # of the CD's last membership change: registrations trickling in
        # on a slow cluster keep re-arming the gate (degrading mid-trickle
        # would snapshot a partial peer env — the flake this fixes), while
        # a quiet domain that simply isn't growing degrades after one
        # grace. A long gap between attempts also re-arms (a fresh kubelet
        # envelope after the first one exhausted gets the strict gate
        # back).
        now = time.monotonic()
        with self._lock:
            # Under self._lock: prepare runs on gRPC handler threads, and
            # the (first, last) read-modify-write is not atomic without
            # it. Claims that never succeed and are never unprepared
            # would otherwise pin entries for the daemon's lifetime —
            # prune anything idle past the gap-reset horizon (its grace
            # would restart anyway).
            stale = [u for u, (_, l) in self._first_attempt.items()
                     if now - l > self.ATTEMPT_GAP_RESET_S and u != uid]
            for u in stale:
                del self._first_attempt[u]
            first, last = self._first_attempt.get(uid, (now, now))
            if now - last > self.ATTEMPT_GAP_RESET_S:
                first = now
            self._first_attempt[uid] = (first, now)
        settled_ref = max(first,
                          self._cd.last_membership_change(config.domain_id,
                                                          default=first))
        strict = (now - settled_ref) < self.DOMAIN_SETTLE_GRACE_S
        cd = self._cd.assert_node_ready(
            config.domain_id, require_domain_ready=strict)  # raises retryable

        env = self._cd.workload_env(cd, channel_ids, config.allocation_mode)
        # Trace continuation: a scheduler-allocated CD
        # channel claim carries a traceparent annotation; the cd.prepare
        # span rides into the workload env so the CD daemon's readiness
        # mirror closes the loop on the same trace.
        span = TRACER.begin(
            "cd.prepare", root=True,
            traceparent=(claim["metadata"].get("annotations") or {}).get(
                TRACEPARENT_ANNOTATION),
            attributes={"claim_uid": uid})
        ok = False
        try:
            tp = span.traceparent()
            if tp:
                env[ENV_TRACEPARENT] = tp
            self._cdi.create_claim_spec_file(uid, env)
            ok = True
        finally:
            if ok:
                span.end()
            else:
                span.abandon("cd claim spec write failed")
        self._first_attempt.pop(uid, None)
        return self._complete(uid)

    def _assert_channels_free_locked(self, claim_uid: str,
                                     channel_ids: List[int]) -> None:
        """Channel exclusivity: a channel held by a *different* claim that
        completed prepare must first be unprepared — orders
        prepare-after-unprepare correctly when kubelet races a new pod
        against a terminating one. Iterates checkpoint claims, so the
        caller must hold ``self._lock``."""
        for other_uid, other in self._checkpoint.claims.items():
            if other_uid == claim_uid or other.state != PREPARE_COMPLETED:
                continue
            held = {d.get("channel_id") for d in other.devices
                    if d.get("type") == deviceinfo.DEVICE_TYPE_CHANNEL}
            clash = held.intersection(channel_ids)
            if clash:
                raise RetryableNotReady(
                    f"channel(s) {sorted(clash)} still prepared for claim "
                    f"{other_uid}")

    # -- daemon claims ------------------------------------------------------

    def _prepare_daemon(self, claim: Dict, results: List[Dict],
                        config: apitypes.ComputeDomainDaemonConfig
                        ) -> PrepareResult:
        uid = claim["metadata"]["uid"]
        cd = self._cd.get_by_uid(config.domain_id)
        if cd is None:
            raise RetryableNotReady(
                f"computedomain {config.domain_id} not found",
                cd_uid=config.domain_id)
        with self._lock:
            self._checkpoint.claims[uid] = PreparedClaim(
                uid=uid, state=PREPARE_STARTED,
                name=claim["metadata"].get("name", ""),
                namespace=claim["metadata"].get("namespace", ""))
            self._checkpoint.claims[uid].devices = [{
                "type": deviceinfo.DEVICE_TYPE_DAEMON,
                "device": r["device"],
                "request": r.get("request", ""),
                "cd_uid": config.domain_id,
                "pool": self._node_name,
                "cdi_ids": [self._cdi.get_claim_device(uid)],
            } for r in results]
            # Mid-prepare intent record: side slot only (see
            # gpuplugin/checkpoint.py CheckpointManager).
            self._ckpt_mgr.store(self._checkpoint, intent=True)

        domain_dir = self._cd.prepare_daemon_dir(cd, self._clique_id)
        env = {
            "COMPUTE_DOMAIN_UUID": cd["metadata"].get("uid", ""),
            "COMPUTE_DOMAIN_NAME": cd["metadata"].get("name", ""),
            "COMPUTE_DOMAIN_NAMESPACE": cd["metadata"].get("namespace", ""),
            "GPU_CLIQUE_ID": self._clique_id,
        }
        mounts = [{
            "hostPath": domain_dir,
            "containerPath": "/var/run/gpu-dra-cd/domain",
            "options": ["rw", "bind"],
        }]
        self._cdi.create_claim_spec_file(uid, env, mounts=mounts)
        return self._complete(uid)

    def _complete(self, uid: str) -> PrepareResult:
        with self._lock:
            prepared = self._checkpoint.claims.get(uid)
            if prepared is None:
                # GC collected the claim (deleted from the API server) while
                # the readiness wait was in flight; don't resurrect it.
                return PrepareResult(
                    error="claim was garbage-collected during prepare")
            prepared.state = PREPARE_COMPLETED
            self._ckpt_mgr.store(self._checkpoint)
            return PrepareResult(devices=[
                self._rehydrate(r) for r in prepared.devices])

    # ------------------------------------------------------------------
    # Unprepare
    # ------------------------------------------------------------------

    def unprepare(self, claim_uid: str) -> Optional[str]:
        self._first_attempt.pop(claim_uid, None)
        # Whole-method serialization: see _label_lock in __init__.
        with self._label_lock:
            return self._unprepare_locked(claim_uid)

    def _unprepare_locked(self, claim_uid: str) -> Optional[str]:
        with self._lock:
            prepared = self._checkpoint.claims.get(claim_uid)
            if prepared is None:
                return None
            cd_uids = {d.get("cd_uid") for d in prepared.devices
                       if d.get("type") == deviceinfo.DEVICE_TYPE_CHANNEL}
            # Last channel claim for a CD releases the node from the domain
            # (the daemon dir GC is deferred to the cleanup sweep).
            still_used = {
                d.get("cd_uid")
                for uid, c in self._checkpoint.claims.items()
                if uid != claim_uid
                for d in c.devices
                if d.get("type") == deviceinfo.DEVICE_TYPE_CHANNEL}
        # Side effects are rolled back *before* the claim leaves the
        # checkpoint: if label removal fails transiently, kubelet's
        # unprepare retry still finds the claim and completes the cleanup.
        # Deleting the
        # record first would make the retry a no-op and leak the label,
        # pinning the daemon pod and blocking other CDs on this node.
        for cd_uid in cd_uids - still_used:
            if cd_uid:
                try:
                    self._cd.remove_node_label(cd_uid)
                except Exception as e:  # noqa: BLE001
                    return f"remove node label for {cd_uid}: {e}"
        with self._lock:
            if claim_uid not in self._checkpoint.claims:
                return None
            # Spec-file delete precedes the pop: if it raises, the claim is
            # still checkpointed and the kubelet retry can finish; popping
            # first would diverge memory from disk and leak the spec file.
            self._cdi.delete_claim_spec_file(claim_uid)
            del self._checkpoint.claims[claim_uid]
            self._ckpt_mgr.store(self._checkpoint)
        return None

    # ------------------------------------------------------------------

    def _rehydrate(self, record: Dict) -> PreparedDevice:
        return PreparedDevice(
            pool_name=record.get("pool", ""),
            device_name=record.get("device", ""),
            cdi_device_ids=list(record.get("cdi_ids") or []),
            request_names=([record["request"]]
                           if record.get("request") else []))

    def prepared_claim_uids(self) -> List[str]:
        with self._lock:
            return list(self._checkpoint.claims)

    def checkpoint_snapshot(self) -> Checkpoint:
        """Deep copy under the lock: GC iterates this while prepare threads
        mutate the live checkpoint."""
        import copy
        with self._lock:
            return copy.deepcopy(self._checkpoint)

    def backfill_claim_identity(self, claim_uid: str, name: str,
                                namespace: str) -> bool:
        """Write name/namespace into a legacy (V1-era) checkpoint record
        that predates claim identity, and persist: the GC sweep pulls the
        missing fields from the API server so legacy records become
        collectible. Returns False when the record vanished meanwhile."""
        with self._lock:
            prepared = self._checkpoint.claims.get(claim_uid)
            if prepared is None:
                return False
            if not prepared.name:
                prepared.name = name
                prepared.namespace = namespace
                self._ckpt_mgr.store(self._checkpoint)
            return True

    def drop_claim(self, claim_uid: str) -> bool:
        """Checkpoint GC hook (cleanup.py). Runs the full unprepare path —
        an abandoned PREPARE_STARTED claim may have added the node label
        before its ResourceClaim was deleted, and kubelet will never call
        unprepare for it; dropping the record without the last-claim label
        accounting would leak the label with nothing left to remove it.
        Returns False when cleanup failed transiently: the record is
        retained and the next GC sweep retries (the caller must not count
        the claim as collected)."""
        err = self.unprepare(claim_uid)
        if err:
            log.warning("GC drop of claim %s deferred: %s", claim_uid, err)
            return False
        return True
