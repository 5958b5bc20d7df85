"""Node device state for GPUs: checkpointed, idempotent Prepare/Unprepare
(counterpart of tpu_dra/tpuplugin/device_state.py).

``prepare_batch`` runs one NodePrepareResources RPC as one unit of work,
in the reference's order: a pure phase under the state lock (idempotency,
allocation parsing, opaque-config resolution with precedence — class <
claim, later-in-list > earlier, device-specific > catch-all — and the
full device records), a durable intent record for hazardous members,
side effects applied per member under its GPU locks (sharing, guards,
the claim CDI spec with the GPUs' UUIDs and fabric coordinates), then
one group-committed terminal journal record and the commit barrier on
the spec writes. A member that fails anywhere unwinds alone. Unprepare
reverses it with one group commit; quarantine keeps a flapping GPU out of
the published inventory across restarts.

Each kind of claim and what it changes on the node:

- GpuConfig: time-slicing sets the GPUs' time slice (not hazardous:
  reconciled at startup); MPS sets the GPUs to EXCLUSIVE_PROCESS and
  starts the claim's MPS control-daemon Deployment (``MpsManager``), and
  the claim gets its pipe directory and limits.
- MigDeviceConfig on a ``mig`` device: the GPU instance at the allocated
  placement and its full-size compute instance are created under the
  GPU's lock, and the claim env names the MIG device's UUID; a placement
  whose memory slices overlap an instance another claim holds, or whose
  GPU a whole-GPU claim holds (and the reverse), is refused.
- PassthroughConfig: exclusive compute mode, and with a
  ``PassthroughManager`` the GPU's IOMMU group rebound to vfio-pci (the
  claim gets only its claim device, with the VFIO nodes); a passthrough
  claim owns its whole group, in both directions.

MPS, MIG and passthrough are hazardous: their intent record is durable
before they run. At startup a claim still PrepareStarted (a crash
mid-prepare) is rolled back, every MIG instance no claim holds is
destroyed and every MPS Deployment no claim holds is stopped.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.api import scheme as apischeme
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cdi.handler import CDIHandler, visible_gpus_env
from tpu_dra_torch.gpuplugin import deviceinfo
from tpu_dra_torch.gpuplugin.checkpoint import (
    Checkpoint, CheckpointManager, PREPARE_COMPLETED, PREPARE_STARTED,
    PreparedClaim,
)
from tpu_dra_torch.gpuplugin.passthrough import (
    PassthroughManager, sysfs_address,
)
from tpu_dra_torch.gpuplugin.sharing import (
    MpsManager, TimeSlicingManager, mps_deployment_name,
)
from tpu_dra_torch.infra import featuregates, vfs
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.infra.trace import (
    ENV_TRACEPARENT, TRACEPARENT_ANNOTATION, TRACER,
)
from tpu_dra_torch.kubeletplugin.server import PreparedDevice, PrepareResult
from tpu_dra_torch.native.gpuinfo import Gpu, GpuInfoBackend
from tpu_dra_torch.topology import mesh as topology_mesh
from tpu_dra_torch.topology.meshexport import export_topology_env

log = logging.getLogger("tpu_dra_torch.gpuplugin")

quarantined_chips_gauge = DefaultRegistry.gauge(
    "tpu_dra_quarantined_chips",
    "GPUs currently quarantined by the flap ladder on this node "
    "(excluded from every ResourceSlice publish until an operator "
    "clear or TTL expiry re-admits them; persisted in the checkpoint "
    "journal so the count survives restarts)")

ENV_SHARING_STRATEGY = "GPU_SHARING_STRATEGY"
ENV_PASSTHROUGH = "GPU_PASSTHROUGH"


class PrepareError(Exception):
    pass


def _config_compatible(cfg: object, dev_type: str) -> bool:
    if isinstance(cfg, apitypes.MigDeviceConfig):
        return dev_type == deviceinfo.DEVICE_TYPE_MIG
    if isinstance(cfg, (apitypes.GpuConfig, apitypes.PassthroughConfig)):
        return dev_type == deviceinfo.DEVICE_TYPE_GPU
    return False


def _prepared_device_from_record(record: Dict) -> PreparedDevice:
    """Rehydrate the kubelet-facing device from a checkpoint record."""
    return PreparedDevice(
        pool_name=record.get("pool", ""),
        device_name=record.get("device", ""),
        cdi_device_ids=list(record.get("cdi_ids") or []),
        request_names=[record["request"]] if record.get("request") else [])


@dataclass
class _ConfigResult:
    """One opaque config + the allocation results it applies to."""
    config: object
    source: str  # FromClass | FromClaim | default
    results: List[Dict] = field(default_factory=list)


@dataclass
class _BatchClaim:
    """One non-idempotent member of a prepare batch, carried from the
    pure phase through apply to the group commit."""
    uid: str
    claim: Dict
    config_results: List[_ConfigResult]
    records: List[Dict]
    hazardous: bool = False    # needs the durable intent store
    serialize: bool = False    # side effects span beyond own GPUs
    slow_apply: bool = False   # apply blocks (exec round trips)
    timings: Dict[str, float] = field(default_factory=dict)
    error: Optional[str] = None
    # Serialized-but-unwritten claim spec (path, text) from the apply
    # phase; the batch submits ONE writer task for all members.
    cdi_spec: Optional[tuple] = None
    # The batch's shared in-flight spec-write future (None once awaited
    # or when specs were written synchronously). The commit barrier
    # awaits it before any result externalizes.
    cdi_future: Optional[object] = None
    # The member's prepare.claim span: its children (prepare.sharing/
    # guards/cdi*/journal) ARE the timings.
    span: Optional[object] = None


class DeviceState:
    def __init__(self, *, backend: GpuInfoBackend, cdi: CDIHandler,
                 checkpoints: CheckpointManager, driver_name: str,
                 node_name: str,
                 ts_manager: Optional[TimeSlicingManager] = None,
                 mps_manager: Optional[MpsManager] = None,
                 pt_manager: Optional[PassthroughManager] = None,
                 include_mig: bool = True,
                 async_cdi: bool = True,
                 quarantine_threshold: int = 3,
                 quarantine_window_s: float = 60.0,
                 quarantine_ttl_s: float = 0.0):
        self._backend = backend
        self._cdi = cdi
        self._ckpt_mgr = checkpoints
        self._driver_name = driver_name
        self._node_name = node_name
        self._ts_manager = ts_manager
        self._mps_manager = mps_manager
        self._pt_manager = pt_manager
        self._lock = threading.Lock()
        gpus = backend.gpus()
        # Publish-time fabric validation: duplicate or out-of-bounds
        # coordinates mean the inventory lies about the NVLink domain.
        topology_mesh.validate_gpus(gpus)
        self.allocatable = deviceinfo.enumerate_allocatable(
            gpus, include_mig=include_mig, mig_profiles=self._mig_profiles)
        self._unhealthy_uuids: set = set()  # GUARDED_BY: _lock
        # Quarantine ladder: a GPU whose unhealthy TRANSITIONS reach
        # `quarantine_threshold` within `quarantine_window_s` is
        # quarantined — excluded from publish until an operator clear or
        # TTL expiry (`quarantine_ttl_s`; 0 = operator-only), and
        # persisted in the checkpoint journal.
        self._q_threshold = max(1, int(quarantine_threshold))
        self._q_window_s = float(quarantine_window_s)
        self._q_ttl_s = float(quarantine_ttl_s)
        # GPU uuid -> monotonic timestamps of recent flaps (transient,
        # deliberately NOT persisted: the quarantine decision is).
        self._flap_history: Dict[str, deque] = {}  # GUARDED_BY: _lock
        # Per-phase ms of the last non-idempotent single-claim prepare.
        self.last_prepare_breakdown: Dict[str, float] = {}
        # Batch-level phase ms of the last fully-successful prepare_batch.
        self.last_batch_breakdown: Dict[str, float] = {}
        # Disjoint-GPU parallel apply: members touching disjoint GPU sets
        # apply concurrently; members sharing a GPU serialize on its
        # lock (MIG creates included). Passthrough and unknown config
        # kinds additionally serialize on _hazard_lock: an IOMMU-group
        # rebind spans beyond the claim's own GPUs.
        self._gpu_locks: Dict[int, threading.Lock] = {
            g.index: threading.Lock() for g in gpus}
        self._hazard_lock = threading.Lock()
        self._apply_pool: Optional[ThreadPoolExecutor] = None
        # Async claim-spec writer pool: spec tmp-write + rename overlap
        # the terminal checkpoint append + group sync; the commit barrier
        # (_await_cdi) runs before any result externalizes. async_cdi=False
        # writes the specs on the batch's own thread (a model checker's
        # interleavings must not leak into an uncontrolled pool thread).
        self._cdi_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=4,
                               thread_name_prefix="gpu-dra-cdi-write")
            if async_cdi else None)
        # The standard per-node CDI spec is written once at startup.
        self._cdi.create_standard_device_spec_file(gpus)
        self._checkpoint = self._ckpt_mgr.load_or_init()
        # Quarantine survives the restart; records for uuids no longer on
        # this node (GPU replaced) are pruned in memory.
        known_uuids = {g.uuid for g in gpus}
        for uuid in list(self._checkpoint.quarantine):
            if uuid not in known_uuids:
                log.info("dropping quarantine record for replaced GPU "
                         "uuid %s", uuid)
                self._checkpoint.quarantine.pop(uuid, None)
        quarantined_chips_gauge.set(len(self._checkpoint.quarantine))
        # Orphan claim-spec GC: non-hazardous prepares skip the intent
        # store, so a crash between their CDI write and terminal store
        # leaves a spec file for a claim the checkpoint never learned of.
        for uid in self._cdi.list_claim_uids():
            if uid not in self._checkpoint.claims:
                self._cdi.delete_claim_spec_file(uid)
        # Orphan time-slice reconciliation: time-slicing prepares skip the
        # intent store too; reset every GPU no checkpointed claim holds to
        # the driver default (once per process start).
        self._rollback_started()
        self._reconcile_mig(gpus)
        self._reconcile_mps(gpus)
        if self._ts_manager is not None:
            held = {record.get("gpu_index")
                    for prepared in self._checkpoint.claims.values()
                    for record in prepared.devices}
            for g in gpus:
                if g.index in held:
                    continue
                try:
                    self._ts_manager.reset([g])
                except Exception:  # noqa: BLE001 — one bad GPU must not
                    # crash-loop the plugin and take the node's GPUs.
                    log.warning("startup time-slice reset failed for "
                                "GPU %d (continuing)", g.index,
                                exc_info=True)

    def _mig_profiles(self, index: int):
        """The GPU-instance profiles of a GPU in MIG mode; none (logged)
        where the backend cannot read them, so the GPU is still served
        whole."""
        try:
            return self._backend.mig_profiles(index)
        except Exception:  # noqa: BLE001 — advertise the GPU whole
            log.warning("MIG profiles of GPU %d unreadable; no MIG devices "
                        "advertised for it", index, exc_info=True)
            return []

    def _rollback_started(self) -> None:
        """Roll back every claim the checkpoint holds PrepareStarted: a
        crash after its intent record left side effects (a Deployment, a
        MIG instance, a rebind) that no claim will own. An unwind that
        fails keeps its record, so unprepare can retry it."""
        started = [(uid, c) for uid, c in self._checkpoint.claims.items()
                   if c.state == PREPARE_STARTED]
        rolled = []
        for uid, prepared in started:
            try:
                self._unprepare_devices(uid, prepared)
            except Exception:  # noqa: BLE001 — one claim must not
                # crash-loop the plugin
                log.warning("startup rollback of claim %s failed; kept "
                            "for unprepare", uid, exc_info=True)
                continue
            self._cdi.delete_claim_spec_file(uid)
            self._checkpoint.claims.pop(uid, None)
            rolled.append(uid)
        if rolled:
            log.info("rolled back claims interrupted mid-prepare: %s",
                     rolled)
            self._ckpt_mgr.store(self._checkpoint)

    def _held_mig_slices(self) -> Dict[int, set]:
        """GPU index -> memory slices of the MIG devices claims hold."""
        held: Dict[int, set] = {}
        for prepared in self._checkpoint.claims.values():
            for record in prepared.devices:
                mig = record.get("mig")
                if mig:
                    held.setdefault(record["gpu_index"], set()).update(
                        range(mig["start"], mig["start"] + mig["size"]))
        return held

    def _reconcile_mig(self, gpus: List[Gpu]) -> None:
        """Destroy every MIG instance on this node that no checkpointed
        claim holds (a crash between its create and the claim's record,
        or a claim rolled back above)."""
        held = self._held_mig_slices()
        for g in gpus:
            if not g.mig_mode:
                continue
            try:
                for d in self._backend.mig_devices(g.index):
                    if d.start in held.get(g.index, ()):
                        continue
                    log.info("destroying MIG instance gi=%d (%s at %d) on "
                             "GPU %d: no claim holds it", d.gi, d.profile,
                             d.start, g.index)
                    self._backend.destroy_mig_device(g.index, d.gi, None)
            except Exception:  # noqa: BLE001 — one bad GPU must not
                # crash-loop the plugin and take the node's GPUs.
                log.warning("startup MIG reconciliation failed for GPU %d "
                            "(continuing)", g.index, exc_info=True)

    def _reconcile_mps(self, gpus: List[Gpu]) -> None:
        """Stop every MPS Deployment of this node that no checkpointed
        claim holds, and clear exclusive mode on its GPUs that no claim
        holds."""
        if self._mps_manager is None:
            return
        held_gpus = {record.get("gpu_index")
                     for prepared in self._checkpoint.claims.values()
                     for record in prepared.devices}
        try:
            leaked = {uid: uuids for uid, uuids in
                      self._mps_manager.claim_deployments().items()
                      if uid not in self._checkpoint.claims}
        except Exception:  # noqa: BLE001 — the API server may be away;
            log.warning("startup MPS reconciliation could not list "
                        "Deployments", exc_info=True)
            return
        for uid, uuids in sorted(leaked.items()):
            free = [g for g in gpus
                    if g.uuid in uuids and g.index not in held_gpus]
            log.info("stopping the MPS daemon of claim %s: no claim holds "
                     "it", uid)
            try:
                self._mps_manager.stop(uid, free)
            except Exception:  # noqa: BLE001 — retried next start
                log.warning("stopping the leaked MPS daemon of claim %s "
                            "failed", uid, exc_info=True)

    @property
    def backend(self) -> GpuInfoBackend:
        """The discovery backend (read-only seam for the health monitor;
        the driver must not reach into _backend)."""
        return self._backend

    def gpu_indices(self) -> List[int]:
        """Indices of every GPU of this node (an event addressed to all
        GPUs marks each; the counterpart of chip_indices)."""
        return [g.index for g in self._backend.gpus()]

    def flush_journal(self) -> None:
        """Settle every appended journal record to disk: the journal
        barrier the driver's drain runs before close(), so the next
        incarnation recovers a complete tail."""
        self._ckpt_mgr.journal_flush()

    def close(self) -> None:
        """Release the pools and cached checkpoint slot fds."""
        if self._apply_pool is not None:
            self._apply_pool.shutdown(wait=True)
            self._apply_pool = None
        if self._cdi_pool is not None:
            self._cdi_pool.shutdown(wait=True)
            self._cdi_pool = None
        self._ckpt_mgr.close()

    # ------------------------------------------------------------------
    # Prepare
    # ------------------------------------------------------------------

    def prepare(self, claim: Dict) -> PrepareResult:
        """claim: a resource.k8s.io/v1 ResourceClaim object (dict). A
        batch of one."""
        return self.prepare_batch([claim])[claim["metadata"]["uid"]]

    def prepare_batch(self, claims: List[Dict]) -> Dict[str, PrepareResult]:
        """Prepare every claim of one NodePrepareResources RPC as ONE
        unit of work: the pure phase and checkpoint mutation under the
        global lock, side effects per member, durable state in group
        commits (one intent store for all hazardous members, one
        terminal store for the whole batch). A member that fails
        mid-apply unwinds itself while the survivors commit; errors
        isolate to the failing claim's result. Every phase is a span;
        the finally here guarantees no span outlives the batch."""
        batch_span = TRACER.begin("prepare.batch", root=True,
                                  attributes={"n_claims": len(claims)})
        todo: List[_BatchClaim] = []
        try:
            return self._prepare_batch_spanned(claims, batch_span, todo)
        finally:
            for b in todo:
                span = b.span
                if span is not None:
                    span.abandon("prepare aborted mid-batch")
            batch_span.end()

    def _prepare_batch_spanned(self, claims: List[Dict],
                               batch_span, todo: List[_BatchClaim]
                               ) -> Dict[str, PrepareResult]:
        results: Dict[str, PrepareResult] = {}
        batch_timings: Dict[str, float] = {}
        with self._lock:
            # Pure phase first (no side effects): config errors return
            # before any state is recorded, and the intent record below
            # already names every GPU each member will touch.
            with TRACER.span("prepare.decode",
                             parent=batch_span) as t_decode:
                for claim in claims:
                    uid = claim["metadata"]["uid"]
                    if uid in results or any(b.uid == uid for b in todo):
                        continue  # duplicate uid in one RPC: one result
                    existing = self._checkpoint.claims.get(uid)
                    if existing is not None and \
                            existing.state == PREPARE_COMPLETED and \
                            self._cdi.claim_spec_exists(uid):
                        # Idempotent fast path — only while the claim CDI
                        # spec is actually on disk.
                        results[uid] = PrepareResult(devices=[
                            _prepared_device_from_record(r)
                            for r in existing.devices])
                        continue
                    try:
                        config_results = self._resolve_claim_configs(claim)
                        records = self._build_records(uid, config_results)
                    except Exception as e:  # noqa: BLE001 — claim error
                        results[uid] = PrepareResult(
                            error=f"prepare devices: {e}")
                        continue
                    configs = [cr.config for cr in config_results]
                    todo.append(_BatchClaim(
                        uid=uid, claim=claim,
                        config_results=config_results,
                        records=records,
                        span=TRACER.begin(
                            "prepare.claim", root=True,
                            traceparent=(claim["metadata"].get(
                                "annotations") or {}).get(
                                TRACEPARENT_ANNOTATION),
                            attributes={"claim_uid": uid}),
                        hazardous=any(self._config_hazard(c)
                                      for c in configs),
                        # Passthrough (an IOMMU-group rebind yanks the
                        # group's other GPUs) and unknown kinds serialize
                        # on the hazard lock; MPS Deployments and MIG
                        # instances are per claim, under GPU locks.
                        serialize=any(
                            not isinstance(c, (apitypes.GpuConfig,
                                               apitypes.MigDeviceConfig))
                            for c in configs),
                        slow_apply=any(
                            not isinstance(c, apitypes.GpuConfig)
                            or c.sharing is not None
                            for c in configs)))
            batch_timings["decode"] = t_decode.duration_s
            if not todo:
                return results
            for b in todo:
                self._checkpoint.claims[b.uid] = PreparedClaim(
                    uid=b.uid, state=PREPARE_STARTED,
                    name=b.claim["metadata"].get("name", ""),
                    namespace=b.claim["metadata"].get("namespace", ""),
                    devices=b.records)
            intent_token: Optional[int] = None
            hazardous = [b for b in todo if b.hazardous]
            if hazardous:
                # ONE mid-prepare journal record covering every hazardous
                # member; the group sync happens outside the state lock.
                with TRACER.span("prepare.checkpoint_start",
                                 parent=batch_span) as t_intent:
                    try:
                        intent_token = self._ckpt_mgr.journal_commit(
                            self._checkpoint,
                            present=[b.uid for b in hazardous],
                            intent=True)
                    except Exception as e:  # noqa: BLE001 — nothing
                        # applied yet: unwind in memory, fail the batch.
                        for b in todo:
                            self._checkpoint.claims.pop(b.uid, None)
                            results[b.uid] = PrepareResult(
                                error=f"intent store: {e}")
                        return results
                batch_timings["checkpoint_start"] = t_intent.duration_s
        if intent_token is not None:
            # Durable intent BEFORE any side effect runs.
            with TRACER.span("prepare.checkpoint_start",
                             parent=batch_span) as t_ibar:
                try:
                    self._ckpt_mgr.journal_barrier(intent_token)
                except Exception as e:  # noqa: BLE001 — sync failed
                    # before any side effect: abort the batch.
                    self._abort_unsynced_intent(todo, results, e)
                    return results
            batch_timings["checkpoint_start"] += t_ibar.duration_s

        # Side effects OUTSIDE the global lock; claim-spec writes are
        # submitted here and awaited at the commit barrier below.
        with TRACER.span("prepare.apply", parent=batch_span) as t_apply:
            self._apply_batch(todo)
            self._submit_spec_writes(todo)
        batch_timings["apply"] = t_apply.duration_s

        token: Optional[int] = None
        failed: List[_BatchClaim] = []
        survivors: List[_BatchClaim] = []
        # uid -> rollback error for members whose unwind could not
        # complete (degraded to a deferred PrepareStarted record).
        deferred: Dict[str, str] = {}
        with self._lock:
            failed = [b for b in todo if b.error is not None]
            survivors = [b for b in todo if b.error is None]
            for b in failed:
                err = self._unwind_claim(b.uid)
                if err is not None:
                    deferred[b.uid] = err
            for b in survivors:
                self._checkpoint.claims[b.uid].state = PREPARE_COMPLETED
            with TRACER.span("prepare.checkpoint_final",
                             parent=batch_span) as t_final:
                try:
                    # The group commit: every member's terminal outcome
                    # in ONE journal record; the durable sync is the
                    # barrier below, outside this lock.
                    token = self._ckpt_mgr.journal_commit(
                        self._checkpoint,
                        present=[b.uid for b in survivors]
                        + sorted(deferred),
                        absent=[b.uid for b in failed
                                if b.uid not in deferred])
                except Exception as e:  # noqa: BLE001 — terminal append
                    # failed: unwind the survivors too and persist the
                    # rollback, so the retry starts from a clean slate.
                    self._await_cdi(todo)
                    self._rollback_survivors_locked(
                        todo, survivors, deferred,
                        f"checkpoint store: {e}")
            batch_timings["checkpoint_final"] = t_final.duration_s

        if token is not None:
            with TRACER.span("prepare.checkpoint_final",
                             parent=batch_span) as t_fbar:
                try:
                    self._ckpt_mgr.journal_barrier(token)
                except Exception as e:  # noqa: BLE001 — durability
                    # unknown: roll the survivors back through the synced
                    # slot path.
                    self._rollback_after_sync_failure(
                        todo, survivors, deferred, e)
                    token = None
            batch_timings["checkpoint_final"] += t_fbar.duration_s
        if token is not None:
            # Commit barrier: claim-spec writes must have landed before
            # any success externalizes.
            cdi_failed = self._await_cdi(todo)
            if cdi_failed:
                with self._lock:
                    self._rollback_survivors_locked(
                        todo, cdi_failed, deferred, "claim spec write")
                lost = {b.uid for b in cdi_failed}
                survivors = [b for b in survivors if b.uid not in lost]
                failed = failed + cdi_failed

        with self._lock:
            batch_timings["total"] = batch_span.duration_s
            for b in todo:
                if b.uid in deferred:
                    log.warning(
                        "prepare rollback for %s incomplete (%s); claim "
                        "left PrepareStarted for deferred unwind", b.uid,
                        deferred[b.uid])
                    results[b.uid] = PrepareResult(
                        error=f"{b.error}; rollback deferred: "
                              f"{deferred[b.uid]}")
                elif b.error is not None:
                    results[b.uid] = PrepareResult(error=b.error)
                else:
                    if token is not None and b.span is not None:
                        # The member's share of the batch's one terminal
                        # append + group sync.
                        TRACER.record_span(
                            "prepare.journal",
                            batch_timings.get("checkpoint_final", 0.0),
                            parent=b.span)
                    results[b.uid] = PrepareResult(devices=[
                        _prepared_device_from_record(r)
                        for r in b.records])
                if b.span is not None:
                    if b.error is not None:
                        b.span.abandon(b.error)
                    else:
                        b.span.end()

            if survivors and not failed:
                self.last_batch_breakdown = {
                    **{k: v * 1e3 for k, v in batch_timings.items()},
                    "n_claims": float(len(todo)),
                }
            if len(todo) == 1 and todo[0].error is None \
                    and not deferred:
                b = todo[0]
                timings = dict(b.timings)
                timings.setdefault("cdi_wait", 0.0)
                timings["decode"] = batch_timings["decode"]
                if "checkpoint_start" in batch_timings:
                    timings["checkpoint_start"] = \
                        batch_timings["checkpoint_start"]
                timings["checkpoint_final"] = \
                    batch_timings["checkpoint_final"]
                timings["total"] = batch_timings["total"]
                self.last_prepare_breakdown = {
                    k: v * 1e3 for k, v in timings.items()}
        return results

    def _abort_unsynced_intent(self, todo: List[_BatchClaim],
                               results: Dict[str, PrepareResult],
                               e: Exception) -> None:
        """Intent group sync failed before any side effect: erase the
        batch from memory and fail every member."""
        with self._lock:
            for b in todo:
                self._checkpoint.claims.pop(b.uid, None)
                results[b.uid] = PrepareResult(
                    error=f"intent store: {e}")

    def _await_cdi(self, todo: List[_BatchClaim]) -> List[_BatchClaim]:
        """The CDI half of the commit barrier: wait out the batch's
        spec-write task; a member whose write failed is marked failed
        and returned for rollback."""
        failed = []
        for b in todo:
            fut = b.cdi_future
            if fut is None:
                continue
            b.cdi_future = None
            with TRACER.span("prepare.cdi_wait",
                             parent=b.span) as t_wait:
                try:
                    errors = fut.result()
                except Exception as e:  # noqa: BLE001 — whole task died
                    errors = {b.uid: str(e)}
            b.timings["cdi_wait"] = (b.timings.get("cdi_wait", 0.0)
                                     + t_wait.duration_s)
            err = errors.get(b.uid)
            if err is not None:
                if b.error is None:
                    b.error = f"prepare devices: {err}"
                failed.append(b)
        return failed

    def _rollback_survivors_locked(self, todo: List[_BatchClaim],
                                   members: List[_BatchClaim],
                                   deferred: Dict[str, str],
                                   err_msg: str) -> None:
        """Terminal commit could not be made durable: unwind `members`
        and persist the rollback through the synced slot path. Caller
        holds _lock and has awaited the CDI futures."""
        for b in members:
            if b.error is None:
                b.error = err_msg
            err = self._unwind_claim(b.uid)
            if err is not None:
                deferred[b.uid] = err
        try:
            self._ckpt_mgr.store(self._checkpoint)
        except Exception as e2:  # noqa: BLE001 — rollback store failed
            # as well: degrade every not-yet-deferred member to a
            # deferred PrepareStarted record.
            for b in todo:
                if b.uid in deferred:
                    continue
                if b.error is None:
                    b.error = f"checkpoint store: {e2}"
                self._checkpoint.claims[b.uid] = PreparedClaim(
                    uid=b.uid, state=PREPARE_STARTED,
                    name=b.claim["metadata"].get("name", ""),
                    namespace=b.claim["metadata"].get(
                        "namespace", ""),
                    devices=b.records)
                deferred[b.uid] = str(e2)
            try:
                self._ckpt_mgr.store(self._checkpoint)
            except Exception:  # noqa: BLE001 — the retry of the
                # rollback store itself: nothing is left to unwind.
                log.warning("failed-batch record store failed",
                            exc_info=True)

    def _rollback_after_sync_failure(self, todo: List[_BatchClaim],
                                     survivors: List[_BatchClaim],
                                     deferred: Dict[str, str],
                                     e: Exception) -> None:
        self._await_cdi(todo)
        with self._lock:
            self._rollback_survivors_locked(
                todo, survivors, deferred, f"checkpoint store: {e}")

    def _apply_batch(self, todo: List[_BatchClaim]) -> None:
        """Every member's side effects; failures land in the member's
        `error` (never raises). Pool dispatch only when at least two
        members block and can overlap."""
        parallelizable = sum(1 for b in todo
                             if b.slow_apply and not b.serialize)
        if len(todo) == 1 or parallelizable < 2:
            for b in todo:
                self._apply_member(b)
            return
        if self._apply_pool is None:
            self._apply_pool = ThreadPoolExecutor(
                max_workers=min(8, max(2, len(self._gpu_locks))),
                thread_name_prefix="gpu-dra-apply")
        futures = [self._apply_pool.submit(self._apply_member, b)
                   for b in todo]
        for f in futures:
            f.result()

    def _apply_member(self, b: _BatchClaim) -> None:
        """One member's side effects under its locks. Never raises."""
        try:
            # Injection site: mid-batch apply failure — the loser must
            # roll back while its batch siblings commit durably.
            FAULTS.check("prepare.batch_apply", claim_uid=b.uid)
            with ExitStack() as stack:
                # Global lock order: hazard first, then ascending GPU index.
                if b.serialize:
                    stack.enter_context(self._hazard_lock)
                for idx in sorted({r["gpu_index"] for r in b.records}):
                    stack.enter_context(self._gpu_locks[idx])
                self._apply_devices(b)
        except Exception as e:  # noqa: BLE001 — report as claim error
            b.error = f"prepare devices: {e}"

    def _unwind_claim(self, uid: str) -> Optional[str]:
        """Transactional unwind of one failed batch member (caller holds
        _lock): reverse the side effects the records name, delete the
        claim CDI spec, erase the checkpoint entry. If the unwind itself
        fails, keep a PrepareStarted record and return the error."""
        prepared = self._checkpoint.claims.get(uid)
        try:
            if prepared is not None:
                self._unprepare_devices(uid, prepared)
            self._cdi.delete_claim_spec_file(uid)
            self._checkpoint.claims.pop(uid, None)
            return None
        except Exception as rollback_err:  # noqa: BLE001 — deferred
            if prepared is not None:
                prepared.state = PREPARE_STARTED
                self._checkpoint.claims[uid] = prepared
            return str(rollback_err)

    def _resolve_claim_configs(self, claim: Dict) -> List[_ConfigResult]:
        """The pure phase of prepare: parse allocation results and resolve
        opaque configs. Raises PrepareError; applies no side effects."""
        allocation = ((claim.get("status") or {}).get("allocation") or {})
        results = [r for r in (allocation.get("devices") or {}).get("results", [])
                   if r.get("driver") == self._driver_name]
        if not results:
            raise PrepareError("claim has no allocation results for this driver")
        return self._resolve_configs(allocation, results)

    def _config_hazard(self, cfg: object) -> bool:
        """Will applying `cfg` mutate state beyond the claim CDI spec file?
        Names only the KNOWN-SAFE cases and answers True for everything
        else."""
        if isinstance(cfg, apitypes.GpuConfig):
            sharing = cfg.sharing
            if sharing is None:
                return False
            if sharing.is_time_slicing():
                # GPU-level and reconciled at startup.
                return False
            return True  # MPS: exclusive mode and a Deployment
        return True  # MIG instances, passthrough and any unknown kind

    def _build_records(self, uid: str,
                       config_results: List[_ConfigResult]) -> List[Dict]:
        """The PURE half of prepare: checkpoint device records with
        deterministic CDI ids for every allocation result."""
        records: List[Dict] = []
        for cr in config_results:
            is_passthrough = isinstance(cr.config, apitypes.PassthroughConfig)
            for result in cr.results:
                dev = self.allocatable.get(result["device"])
                if dev is None:
                    raise PrepareError(
                        f"allocated device {result['device']!r} is not on "
                        "this node")
                # Passthrough claims get ONLY the claim device.
                cdi_ids = ([self._cdi.get_claim_device(uid)]
                           if is_passthrough else
                           [self._cdi.get_standard_device(dev.gpu.uuid),
                            self._cdi.get_claim_device(uid)])
                record = {
                    "type": dev.type,
                    "device": dev.name,
                    "request": result.get("request", ""),
                    "gpu_index": dev.gpu.index,
                    "gpu_uuid": dev.gpu.uuid,
                    "pool": self._node_name,
                    "config": cr.config.to_dict(),
                    "cdi_ids": cdi_ids,
                }
                if dev.type == deviceinfo.DEVICE_TYPE_MIG:
                    # The placement, known before the instance exists:
                    # what reconciliation matches a live instance by. The
                    # instance's ids and UUID join it once created.
                    record["mig"] = {"profile": dev.mig.profile,
                                     "start": dev.mig.start,
                                     "size": dev.mig.size}
                sharing = getattr(cr.config, "sharing", None)
                if sharing is not None and sharing.is_mps():
                    record["mps_deployment"] = mps_deployment_name(uid)
                records.append(record)
        migs = [r["gpu_index"] for r in records if "mig" in r]
        if len(migs) != len(set(migs)):
            raise PrepareError("a claim takes at most one MIG device of "
                               "each GPU")
        return records

    def _apply_devices(self, b: _BatchClaim) -> None:
        """The side-effect half of prepare: sharing setup, the guards,
        MIG instances, passthrough exclusive mode and rebind, and the
        claim CDI spec — serialized here and written by the batch's
        writer task (the commit barrier awaits it)."""
        claim, config_results, timings = b.claim, b.config_results, b.timings
        uid = claim["metadata"]["uid"]

        claim_gpus: Dict[int, Gpu] = {}
        claim_env: Dict[str, str] = {}
        claim_mounts: List[Dict] = []
        claim_nodes: List[Dict] = []
        mig_uuids: Dict[int, str] = {}

        for cr in config_results:
            group_gpus = self._gpus_for_results(cr.results)
            with TRACER.span("prepare.sharing", parent=b.span) as t_sh:
                edits = self._apply_sharing_config(uid, cr, group_gpus)
            timings["sharing"] = (timings.get("sharing", 0.0)
                                  + t_sh.duration_s)
            claim_env.update(edits.get("env", {}))
            claim_mounts.extend(edits.get("mounts", []))
            with TRACER.span("prepare.guards", parent=b.span) as t_gd:
                for result in cr.results:
                    dev = self.allocatable[result["device"]]
                    gpu = dev.gpu
                    claim_gpus[gpu.index] = gpu
                    self._assert_mig_exclusive(dev, uid)
                    if dev.type == deviceinfo.DEVICE_TYPE_MIG:
                        mig = self._create_mig(b, dev)
                        mig_uuids[gpu.index] = mig.uuid
                        if mig.caps:
                            claim_nodes.extend(n for n in
                                               self._cdi.mig_device_nodes(
                                                   gpu, mig.caps)
                                               if n not in claim_nodes)
                    elif isinstance(cr.config, apitypes.PassthroughConfig):
                        if self._pt_manager is not None:
                            self._assert_group_exclusive(gpu, uid,
                                                         passthrough=True)
                        self._backend.set_exclusive_mode(gpu.index, True)
                        claim_env[ENV_PASSTHROUGH] = "true"
                        if self._pt_manager is not None:
                            # The GPU leaves its driver with its whole
                            # IOMMU group; the guard above made that safe.
                            group = self._pt_manager.configure(
                                gpu, sibling_dev_paths=self._group_dev_paths(
                                    gpu))
                            claim_nodes.extend(
                                n for n in
                                self._pt_manager.cdi_device_nodes(group)
                                if n not in claim_nodes)
                    elif self._pt_manager is not None:
                        # Reverse guard: no claim lands on a GPU whose
                        # group a passthrough claim holds on vfio-pci.
                        self._assert_group_exclusive(gpu, uid,
                                                     passthrough=False)
            timings["guards"] = (timings.get("guards", 0.0)
                                 + t_gd.duration_s)

        gpus = [claim_gpus[i] for i in sorted(claim_gpus)]
        claim_env.update(visible_gpus_env(gpus, mig_uuids))
        # Allocation -> mesh handoff: the GPUs' fabric coordinates and
        # declared topology next to their UUIDs, so the workload's mesh
        # builder lays ranks over the same allocation.
        claim_env.update(export_topology_env(gpus))
        # The claim's trace continues in the workload's mesh build.
        if b.span is not None:
            tp = b.span.traceparent()
            if tp:
                claim_env[ENV_TRACEPARENT] = tp
        with TRACER.span("prepare.cdi_write", parent=b.span) as t_cdi:
            path, text = self._cdi.serialize_claim_spec(
                uid, claim_env, mounts=claim_mounts or None,
                device_nodes=claim_nodes or None)
            if self._cdi_pool is not None and vfs.installed() is None:
                b.cdi_spec = (path, text)
            else:
                self._cdi.write_claim_spec(path, text)
        timings["cdi_write"] = t_cdi.duration_s

    def _create_mig(self, b: _BatchClaim, dev):
        """Create the MIG device of `dev`'s placement (under its GPU's
        lock) and put its instance ids and UUID into the claim's record,
        which the terminal commit persists."""
        p = dev.mig
        mig = self._backend.create_mig_device(dev.gpu.index, p.profile,
                                              p.start)
        for i, record in enumerate(b.records):
            if record["device"] == dev.name:
                b.records[i] = {**record, "mig": {
                    **record["mig"], "gi": mig.gi, "ci": mig.ci,
                    "uuid": mig.uuid}}
        return mig

    def _assert_mig_exclusive(self, dev, claim_uid: str) -> None:
        """A MIG device and its GPU exclude each other across claims: a
        MIG prepare is refused where another claim holds the GPU whole or
        a MIG device whose memory slices overlap its placement, and a
        whole-GPU prepare where another claim holds a MIG device of the
        GPU. Every member's record is in the checkpoint before any apply
        begins, so of two racing conflicting claims at least one sees the
        other's (kubelet's retry breaks a tie where both refuse)."""
        is_mig = dev.type == deviceinfo.DEVICE_TYPE_MIG
        want = set(dev.mig.slices) if is_mig else None
        for uid, prepared in list(self._checkpoint.claims.items()):
            if uid == claim_uid:
                continue
            for record in prepared.devices:
                if record.get("gpu_index") != dev.gpu.index:
                    continue
                mig = record.get("mig")
                if is_mig and mig is None:
                    raise PrepareError(
                        f"GPU {dev.gpu.index} is held whole by claim {uid}; "
                        f"MIG device {dev.name} cannot be created on it")
                if not is_mig and mig is not None:
                    raise PrepareError(
                        f"GPU {dev.gpu.index} holds MIG device "
                        f"{record['device']} of claim {uid}; it cannot be "
                        "claimed whole")
                if is_mig and want & set(range(
                        mig["start"], mig["start"] + mig["size"])):
                    raise PrepareError(
                        f"MIG device {dev.name} overlaps the memory slices "
                        f"of {record['device']} held by claim {uid}")

    def _group_gpu_indices(self, gpu: Gpu) -> List[int]:
        """Indices of every GPU in `gpu`'s IOMMU group (itself included);
        just [gpu.index] where the group is unknown."""
        group = self._pt_manager.group_of(gpu)
        if group is None:
            return [gpu.index]
        addrs = set(self._pt_manager.group_devices(group))
        return [g.index for g in self._backend.gpus()
                if sysfs_address(g.pci_bus_id) in addrs] or [gpu.index]

    def _group_dev_paths(self, gpu: Gpu) -> Dict[str, str]:
        """Sysfs address -> device node of the other GPUs in `gpu`'s
        IOMMU group."""
        group = self._pt_manager.group_of(gpu)
        if group is None:
            return {}
        addrs = set(self._pt_manager.group_devices(group))
        return {sysfs_address(g.pci_bus_id): g.dev_path
                for g in self._backend.gpus()
                if sysfs_address(g.pci_bus_id) in addrs
                and g.index != gpu.index}

    def _assert_group_exclusive(self, gpu: Gpu, claim_uid: str, *,
                                passthrough: bool) -> None:
        """VFIO IOMMU-group exclusivity: a passthrough claim owns its
        whole group, so a passthrough prepare is refused where any other
        claim holds a GPU of the group, and any prepare where a
        passthrough claim holds one (its /dev/nvidiaN is gone while the
        group sits on vfio-pci)."""
        group = set(self._group_gpu_indices(gpu))
        for uid, prepared in list(self._checkpoint.claims.items()):
            if uid == claim_uid:
                continue
            for record in prepared.devices:
                if record.get("gpu_index") not in group:
                    continue
                other_is_pt = (record.get("config") or {}).get(
                    "kind") == apitypes.PASSTHROUGH_CONFIG_KIND
                if passthrough or other_is_pt:
                    raise PrepareError(
                        f"GPU {gpu.index} shares an IOMMU group with GPU "
                        f"{record['gpu_index']} held by claim {uid}; VFIO "
                        "passthrough takes the whole group")

    def _submit_spec_writes(self, todo: List[_BatchClaim]) -> None:
        """ONE writer task for every member's pending spec. Members that
        failed apply never write a spec."""
        pending = [(b.uid, b.cdi_spec, b.timings, b.span) for b in todo
                   if b.cdi_spec is not None and b.error is None]
        for b in todo:
            b.cdi_spec = None
        if not pending:
            return
        fut = self._cdi_pool.submit(self._write_claim_specs, pending)
        for b in todo:
            if b.error is None:
                b.cdi_future = fut

    def _write_claim_specs(self, pending) -> Dict[str, str]:
        """The batch's spec I/O on the writer pool: uid -> error for
        any member whose write failed."""
        errors: Dict[str, str] = {}
        for uid, (path, text), timings, span in pending:
            with TRACER.span("prepare.cdi_io", parent=span) as t_io:
                try:
                    self._cdi.write_claim_spec(path, text)
                except Exception as e:  # noqa: BLE001 — isolate the
                    errors[uid] = str(e)  # member
            timings["cdi_io"] = (timings.get("cdi_io", 0.0)
                                 + t_io.duration_s)
        return errors

    def _gpus_for_results(self, results: List[Dict]) -> List[Gpu]:
        gpus: Dict[int, Gpu] = {}
        for result in results:
            dev = self.allocatable.get(result["device"])
            if dev is None:
                raise PrepareError(
                    f"allocated device {result['device']!r} is not on this node")
            gpus[dev.gpu.index] = dev.gpu
        return [gpus[i] for i in sorted(gpus)]

    # -- opaque config resolution -------------------------------------------

    def _resolve_configs(self, allocation: Dict,
                         results: List[Dict]) -> List[_ConfigResult]:
        """Opaque configs -> the allocation results each applies to."""
        configs = self._decode_opaque_configs(allocation)
        out: List[_ConfigResult] = []
        for result in results:
            dev = self.allocatable.get(result["device"])
            dev_type = dev.type if dev else deviceinfo.DEVICE_TYPE_GPU
            chosen: Optional[Tuple[int, object, str]] = None
            for rank, (source, requests, cfg) in enumerate(configs):
                if requests and result.get("request") not in requests:
                    continue
                # A request-targeted kind mismatch is an error, a
                # catch-all config of the wrong kind is skipped.
                if not _config_compatible(cfg, dev_type):
                    if requests:
                        raise PrepareError(
                            f"config kind {type(cfg).KIND} does not apply to "
                            f"{dev_type} device {result['device']!r}")
                    continue
                # Later entries win; FromClaim outranks FromClass because
                # claim configs are appended after class configs.
                chosen = (rank, cfg, source)
            if chosen is None:
                cfg = (apitypes.MigDeviceConfig()
                       if dev_type == deviceinfo.DEVICE_TYPE_MIG
                       else apitypes.GpuConfig.default())
                source = "default"
            else:
                _, cfg, source = chosen
            cfg.normalize()
            cfg.validate()
            for cr in out:
                if cr.config.to_dict() == cfg.to_dict() and cr.source == source:
                    cr.results.append(result)
                    break
            else:
                out.append(_ConfigResult(config=cfg, source=source,
                                         results=[result]))
        return out

    def _decode_opaque_configs(self, allocation: Dict):
        """Returns [(source, requests, config)] ordered FromClass-first so
        list order encodes precedence."""
        entries = (allocation.get("devices") or {}).get("config", []) or []
        ordered = ([e for e in entries if e.get("source") == "FromClass"]
                   + [e for e in entries if e.get("source") != "FromClass"])
        decoded = []
        for entry in ordered:
            opaque = entry.get("opaque") or {}
            if opaque.get("driver") != self._driver_name:
                continue
            try:
                cfg = apischeme.StrictDecoder.decode(opaque.get("parameters", {}))
            except apischeme.DecodeError as e:
                raise PrepareError(f"invalid opaque config: {e}") from e
            decoded.append((entry.get("source", ""),
                            list(entry.get("requests") or []), cfg))
        return decoded

    # -- sharing -------------------------------------------------------------

    def _apply_sharing_config(self, claim_uid: str, cr: _ConfigResult,
                              gpus: List[Gpu]) -> Dict:
        """The claim CDI edits ({env, mounts}) a config's sharing strategy
        contributes, after applying it. The default config has no sharing
        and reaches no setter; a MIG device's time-slicing is the
        driver's and sets nothing."""
        sharing = getattr(cr.config, "sharing", None)
        if sharing is None:
            return {}
        if sharing.is_time_slicing():
            if not featuregates.enabled(featuregates.TimeSlicingSettings):
                return {}
            env = {"env": {ENV_SHARING_STRATEGY: "time-slicing"}}
            if isinstance(cr.config, apitypes.MigDeviceConfig):
                return env
            if self._ts_manager is None:
                raise PrepareError("time-slicing requested but manager disabled")
            self._ts_manager.set_timeslice(
                gpus, sharing.time_slicing_config
                or apitypes.TimeSlicingConfig())
            return env
        if sharing.is_mps():
            if self._mps_manager is None:
                raise PrepareError("MPS requested but manager disabled")
            daemon = self._mps_manager.start(
                claim_uid, gpus, sharing.mps_config or apitypes.MpsConfig())
            edits = daemon.cdi_edits()
            edits["env"][ENV_SHARING_STRATEGY] = "mps"
            return edits
        return {}

    # ------------------------------------------------------------------
    # Unprepare
    # ------------------------------------------------------------------

    def unprepare(self, claim_uid: str) -> Optional[str]:
        """Returns error string or None (idempotent: unknown claim is a
        no-op success). A batch of one."""
        return self.unprepare_batch([claim_uid])[claim_uid]

    def unprepare_batch(self, claim_uids: List[str]
                        ) -> Dict[str, Optional[str]]:
        """Unprepare every claim of one NodeUnprepareResources RPC with
        a single group-committed terminal store. Unknown claims are no-op
        successes (orphan CDI specs still scrubbed), a failed device
        unwind isolates to its claim, and a failed store reinserts every
        removed entry — memory must not run ahead of disk."""
        results: Dict[str, Optional[str]] = {}
        token: Optional[int] = None
        removed: List[Tuple[str, PreparedClaim]] = []
        to_unwind: List[Tuple[str, PreparedClaim]] = []
        seen: set = set()
        with self._lock:
            for claim_uid in claim_uids:
                if claim_uid in seen:
                    continue  # duplicate uid in one RPC
                seen.add(claim_uid)
                prepared = self._checkpoint.claims.get(claim_uid)
                if prepared is None:
                    self._cdi.delete_claim_spec_file(claim_uid)
                    results[claim_uid] = None
                    continue
                to_unwind.append((claim_uid, prepared))
        # Device unwind OUTSIDE the global lock (it serializes on the
        # hazard/GPU locks); the checkpoint entry stays until the
        # terminal phase, so guards keep refusing conflicting prepares.
        unwound: List[Tuple[str, PreparedClaim]] = []
        for claim_uid, prepared in to_unwind:
            try:
                self._unprepare_devices(claim_uid, prepared)
            except Exception as e:  # noqa: BLE001 — isolate the claim
                results[claim_uid] = f"unprepare devices: {e}"
                continue
            unwound.append((claim_uid, prepared))
        with self._lock:
            for claim_uid, prepared in unwound:
                self._cdi.delete_claim_spec_file(claim_uid)
                if self._checkpoint.claims.pop(claim_uid, None) is not None:
                    removed.append((claim_uid, prepared))
                results[claim_uid] = None
            if removed:
                try:
                    token = self._ckpt_mgr.journal_commit(
                        self._checkpoint,
                        absent=[uid for uid, _ in removed])
                except Exception as e:  # noqa: BLE001 — reinsert ALL
                    for claim_uid, prepared in removed:
                        self._checkpoint.claims[claim_uid] = prepared
                        results[claim_uid] = \
                            f"unprepare checkpoint store: {e}"
        if token is not None:
            try:
                self._ckpt_mgr.journal_barrier(token)
            except Exception as e:  # noqa: BLE001 — durability unknown
                self._reinsert_unprepared(removed, results, e)
        return results

    def _reinsert_unprepared(self, removed: List[Tuple[str, PreparedClaim]],
                             results: Dict[str, Optional[str]],
                             e: Exception) -> None:
        """Unprepare group sync failed: reinsert every removed entry and
        persist the reinsertion through the synced slot path."""
        with self._lock:
            for claim_uid, prepared in removed:
                self._checkpoint.claims[claim_uid] = prepared
                results[claim_uid] = f"unprepare checkpoint store: {e}"
            try:
                self._ckpt_mgr.store(self._checkpoint)
            # dralint: ignore[R7] — reinsertion above is the compensation; this store is best-effort durability for it
            except Exception:  # noqa: BLE001
                log.warning("unprepare rollback store failed",
                            exc_info=True)

    def _unprepare_devices(self, claim_uid: str, prepared: PreparedClaim) -> None:
        """Reverse a claim's GPU-level side effects under the same
        hazard/GPU locks the apply phase takes (same global order)."""
        gpus: Dict[int, Gpu] = {}
        strategies = set()
        passthrough_gpus = []
        migs = []   # (GPU index, GPU-instance id) this claim created
        for record in prepared.devices:
            try:
                gpu = self._backend.get_gpu(record["gpu_index"])
            except KeyError:
                continue  # GPU vanished; nothing to reset
            gpus[gpu.index] = gpu
            cfg = record.get("config") or {}
            if record.get("mig"):
                if record["mig"].get("gi") is not None:
                    migs.append((gpu.index, record["mig"]["gi"]))
                continue   # its time-slicing set nothing on the GPU
            sharing = cfg.get("sharing") or {}
            if sharing.get("strategy"):
                strategies.add(sharing["strategy"])
            if cfg.get("kind") == apitypes.PASSTHROUGH_CONFIG_KIND:
                passthrough_gpus.append(gpu)
        gpu_list = [gpus[i] for i in sorted(gpus)]
        with ExitStack() as stack:
            if passthrough_gpus:
                stack.enter_context(self._hazard_lock)
            for idx in sorted(gpus):
                stack.enter_context(self._gpu_locks[idx])
            if apitypes.MpsStrategy in strategies and self._mps_manager:
                self._mps_manager.stop(claim_uid, gpu_list)
            if apitypes.TimeSlicingStrategy in strategies \
                    and self._ts_manager:
                self._ts_manager.reset(gpu_list)
            for index, gi in migs:
                self._backend.destroy_mig_device(index, gi, None)
            for gpu in passthrough_gpus:
                if self._pt_manager is not None:
                    # Back to the nvidia driver before the exclusive mode
                    # clears; unconfigure is idempotent, so a claim that
                    # crashed half-prepared unwinds too.
                    self._pt_manager.unconfigure(gpu)
                self._backend.set_exclusive_mode(gpu.index, False)

    # ------------------------------------------------------------------
    # Health / inventory
    # ------------------------------------------------------------------

    def mark_unhealthy(self, gpu_index: int) -> List[str]:
        """Mark the GPU's devices unhealthy; returns affected device
        names. Each TRANSITION into unhealthy (a flap) counts against the
        sliding window; crossing the threshold quarantines the GPU and
        persists the ledger through the journal (group sync outside the
        lock). A persistence failure (health.flap site) leaves the GPU
        transient-unhealthy and the NEXT flap retries."""
        token: Optional[int] = None
        with self._lock:
            affected = []
            uuid = None
            for name, dev in self.allocatable.items():
                if dev.gpu.index == gpu_index:
                    uuid = dev.gpu.uuid
                    affected.append(name)
            if uuid is None:
                return affected
            is_flap = uuid not in self._unhealthy_uuids
            self._unhealthy_uuids.add(uuid)
            if is_flap and uuid not in self._checkpoint.quarantine:
                now = time.monotonic()
                hist = self._flap_history.setdefault(uuid, deque())
                hist.append(now)
                while hist and hist[0] < now - self._q_window_s:
                    hist.popleft()
                if len(hist) >= self._q_threshold:
                    token = self._quarantine_locked(
                        uuid, gpu_index,
                        reason=f"{len(hist)} flaps within "
                               f"{self._q_window_s:g}s")
        if token is not None:
            self._quarantine_barrier(token)
        return affected

    def _quarantine_locked(self, uuid: str, gpu_index: int, *,
                           reason: str) -> Optional[int]:
        """Quarantine one GPU under _lock; returns the journal token to
        barrier outside the lock (None: persistence refused). Never
        raises."""
        record = {
            "gpu_index": gpu_index,
            "reason": reason,
            "flaps": len(self._flap_history.get(uuid, ())),
            "since": time.time(),
        }
        if self._q_ttl_s > 0:
            record["ttl_s"] = self._q_ttl_s
        try:
            # Injection site: the graduation's journal append fails.
            FAULTS.check("health.flap", gpu_index=gpu_index)
            self._checkpoint.quarantine[uuid] = record
            token = self._ckpt_mgr.journal_commit(
                self._checkpoint, quarantine=True)
        except Exception as e:  # noqa: BLE001 — degrade, retry on flap
            self._checkpoint.quarantine.pop(uuid, None)
            log.warning("quarantine of GPU %d could not persist (%s); "
                        "GPU stays transient-unhealthy until the next "
                        "flap retries", gpu_index, e)
            return None
        self._flap_history.pop(uuid, None)
        quarantined_chips_gauge.set(len(self._checkpoint.quarantine))
        log.warning("GPU %d QUARANTINED (%s); excluded from publish "
                    "until operator clear%s", gpu_index, reason,
                    f" or TTL {self._q_ttl_s:g}s" if self._q_ttl_s > 0
                    else "")
        return token

    def _quarantine_barrier(self, token: int) -> None:
        """The durable half of a quarantine transition, outside _lock."""
        try:
            self._ckpt_mgr.journal_barrier(token, urgent=True)
        except Exception:  # noqa: BLE001 — safe-direction degradation
            log.warning("quarantine journal sync failed; record may not "
                        "be durable until the next group sync",
                        exc_info=True)

    def mark_healthy(self, gpu_index: int) -> List[str]:
        """A recovery event re-admits the GPU's devices — unless it is
        quarantined: only clear_quarantine or TTL expiry re-admits."""
        with self._lock:
            affected = [name for name, dev in self.allocatable.items()
                        if dev.gpu.index == gpu_index
                        and dev.gpu.uuid in self._unhealthy_uuids
                        and dev.gpu.uuid not in self._checkpoint.quarantine]
            for name in affected:
                self._unhealthy_uuids.discard(
                    self.allocatable[name].gpu.uuid)
            return affected

    def quarantined_gpus(self) -> Dict[str, Dict]:
        """uuid -> quarantine record snapshot (operator introspection)."""
        with self._lock:
            return {uuid: dict(rec) for uuid, rec in
                    self._checkpoint.quarantine.items()}

    def clear_quarantine(self, gpu_index: Optional[int] = None
                         ) -> List[str]:
        """Operator seam: lift the quarantine of `gpu_index` (None = every
        GPU), persist the cleared ledger, and return the re-admitted
        device names."""
        token: Optional[int] = None
        with self._lock:
            cleared = [uuid for uuid, rec in
                       self._checkpoint.quarantine.items()
                       if gpu_index is None
                       or rec.get("gpu_index") == gpu_index]
            if not cleared:
                return []
            saved = {uuid: self._checkpoint.quarantine[uuid]
                     for uuid in cleared}
            affected = self._clear_quarantine_locked(cleared)
            try:
                token = self._ckpt_mgr.journal_commit(
                    self._checkpoint, quarantine=True)
            except Exception:  # noqa: BLE001 — degrade to the slot
                # scheme before giving up.
                log.warning("quarantine clear journal append failed; "
                            "degrading to slot store", exc_info=True)
                try:
                    self._ckpt_mgr.store(self._checkpoint)
                except Exception:  # noqa: BLE001 — nothing durable
                    # accepted the clear: ROLL IT BACK.
                    self._checkpoint.quarantine.update(saved)
                    quarantined_chips_gauge.set(
                        len(self._checkpoint.quarantine))
                    log.error("quarantine clear could not persist on "
                              "any scheme; clear rolled back for %s",
                              sorted(saved), exc_info=True)
                    return []
        if token is not None:
            self._quarantine_barrier(token)
        return affected

    def _clear_quarantine_locked(self, uuids: List[str]) -> List[str]:
        affected = []
        for uuid in uuids:
            self._checkpoint.quarantine.pop(uuid, None)
            self._unhealthy_uuids.discard(uuid)
            self._flap_history.pop(uuid, None)
            affected.extend(name for name, dev in self.allocatable.items()
                            if dev.gpu.uuid == uuid)
        quarantined_chips_gauge.set(len(self._checkpoint.quarantine))
        return sorted(affected)

    def healthy_devices(self) -> List[Dict]:
        """resourceapi device list excluding unhealthy AND quarantined
        GPUs. Expired quarantine TTLs are lifted here."""
        token: Optional[int] = None
        with self._lock:
            now = time.time()
            expired = [uuid for uuid, rec in
                       self._checkpoint.quarantine.items()
                       if rec.get("ttl_s")
                       and now >= rec.get("since", now) + rec["ttl_s"]]
            if expired:
                readmitted = self._clear_quarantine_locked(expired)
                log.info("quarantine TTL expired; re-admitting %s",
                         readmitted)
                try:
                    token = self._ckpt_mgr.journal_commit(
                        self._checkpoint, quarantine=True)
                except Exception:  # noqa: BLE001 — next transition
                    # re-persists; exclusion already lifted in memory.
                    log.warning("quarantine TTL clear could not persist",
                                exc_info=True)
            devices = [dev.to_resource_api()
                       for name, dev in sorted(self.allocatable.items())
                       if dev.gpu.uuid not in self._unhealthy_uuids
                       and dev.gpu.uuid not in self._checkpoint.quarantine]
        if token is not None:
            self._quarantine_barrier(token)
        return devices

    def prepared_claim_uids(self) -> List[str]:
        with self._lock:
            return list(self._checkpoint.claims)

    def checkpoint_snapshot(self) -> Checkpoint:
        with self._lock:
            return self._checkpoint
