"""Chaos convergence harness (counterpart of tpu_dra/simcluster/chaos.py):
seeded randomized fault schedules against full claim lifecycles, with
invariants asserted after quiesce.

The production stack under test is real — ``GpuDriver`` + ``DeviceState``
+ ``CheckpointManager`` + ``CDIHandler`` + ``TimeSlicingManager`` over a
``RetryingApiClient``-wrapped ``FakeCluster`` — only the kubelet gRPC hop
is skipped (the wire adds nothing to the failure model). Faults enter
through the ``tpu_dra_torch.infra.faults`` sites the production code
itself consults: API request errors, watch drops, CDI write failures,
checkpoint store failures and torn slots, plugin crashes (rebuild from
disk), and GPU health events.

Each schedule is a seeded random walk over lifecycle operations
(prepare, retry, unprepare, crash-restart, health event, re-arm faults).
After the walk, faults are disarmed (quiesce) and the harness drives
every in-flight claim to its terminal state, then asserts:

1. every claim converged — prepared-and-ready or cleanly unallocated;
2. no orphaned CDI spec files (specs on disk == completed claims);
3. no leaked checkpoint entries (checkpoint == completed claims);
4. the published ResourceSlice matches the healthy-GPU device set;
5. a final crash-restart recovers the same state (crash consistency);
6. full teardown leaves zero residue;

plus the lock-order witness (``infra.lockwitness``: an acyclic graph and
no outlier-length hold inside the walk's window) and the open-span
window (every span the walk began is closed). The scheduler walks add
their own invariants (``SchedulerChaosHarness`` and its subclasses: the
scheduler pool at ``workers=4``, leader kills, topology, node death) and
check the zero-copy view shadow (``informer.SHADOW``).

Where the GPU world differs from the reference's TPU world, the data is
adapted and the invariants are the reference's:

- claims name ``gpu-N`` devices of ``GPU_DRIVER_NAME`` (``gpu.dev``),
  and the time-slicing claim config is a ``GpuConfig``; the reference's
  subslice claims are MIG devices (``gpu-N-mig-...``), so the fake GPUs
  run in MIG mode;
- health events are XIDs of the ``xid`` kind; the feature gates are the
  port's (``NVMLDeviceHealthCheck`` off, ``TimeSlicingSettings`` on);
- the scheduler walks seed GPU nodes (``testing.seed_sched_inventory``);
  the topology and node-death walks run 4 nodes x 8 GPUs, two nodes per
  NVLink clique, with claims of 1, 2 and 4 GPUs (the reference runs 4
  nodes x 16 v5p chips, two hosts per slice, and 8-chip nodes in the
  node-death walk), and the mesh handoff reads
  ``plan.modeled_nvlink_gbps``;
- the node-death walk draws its mid-walk mesh probe from an rng of its
  own, so the walk's op sequence (its node kills included) is set by the
  seed alone, whatever the scheduler's timing.

``python -m tpu_dra_torch.simcluster.chaos --seeds N --events M`` runs
the seed matrix over every walk and prints the reference's summary keys;
violations exit non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import shutil
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_dra_torch.api.types import (
    API_VERSION, GPU_CONFIG_KIND, GPU_DRIVER_NAME,
)
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.gpuplugin.checkpoint import (
    PREPARE_COMPLETED, CheckpointManager,
)
from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.gpuplugin.driver import GpuDriver
from tpu_dra_torch.gpuplugin.health import RECOVERED_KIND
from tpu_dra_torch.gpuplugin.sharing import TimeSlicingManager
from tpu_dra_torch.infra import featuregates, lockwitness, trace
from tpu_dra_torch.infra.faults import (
    FAULTS, EveryNth, OneShot, Probabilistic, Schedule,
)
from tpu_dra_torch.k8s import (
    NODES, PODS, RESOURCECLAIMS, RESOURCESLICES, FakeCluster,
    RetryingApiClient,
)
from tpu_dra_torch.k8s import informer as informer_mod
from tpu_dra_torch.k8s.informer import Informer
from tpu_dra_torch.kubeletplugin.server import Claim, PrepareResult
from tpu_dra_torch.native.gpuinfo import (
    FakeBackend, HealthEvent, default_fake_gpus,
)

log = logging.getLogger("tpu_dra_torch.simcluster.chaos")

# Sites the random walk may arm. Health events are injected directly
# (driver callback) for determinism; cddaemon.spawn belongs to the CD
# daemon stack, exercised by its own tests. The prepare.batch_* sites
# fire inside the batched prepare pipeline (driver fetch fan-out and
# DeviceState parallel apply), so the group-commit rollback machinery is
# chaos-tested on the exact production path; the prepare.journal_* sites
# break the append-only journal's append and bounded-lag compaction the
# same way. prepare.rpc_admit refuses RPCs at the pipeline's admission
# seam before any window slot or ordering gate exists: the walk must see
# a clean per-claim failure and retry, never a leaked gate wedging a
# successor RPC. health.flap breaks the quarantine ladder's graduation
# persistence: the GPU must degrade to transient-unhealthy and
# re-graduate, never half-quarantine.
CHAOS_SITES = ("k8s.api.request", "cdi.claim_write", "checkpoint.store",
               "checkpoint.corrupt", "prepare.rpc_admit",
               "prepare.batch_fetch",
               "prepare.batch_apply", "prepare.journal_append",
               "prepare.journal_compact", "health.flap", "trace.emit")

TS_CONFIG = [{"source": "FromClaim", "requests": [], "opaque": {
    "driver": GPU_DRIVER_NAME, "parameters": {
        "apiVersion": API_VERSION, "kind": GPU_CONFIG_KIND,
        "sharing": {"strategy": "TimeSlicing",
                    "timeSlicingConfig": {"interval": "Short"}}}}}]

# XIDs the walk's health events carry (critical ones: a double-bit ECC
# error, a GPU fallen off the bus, uncontained ECC errors); the driver
# callback yanks on any non-recovered event.
HEALTH_XIDS = (48, 79, 94, 95)

# Lock-hold outlier threshold for the witness invariant: generous
# against CI scheduling jitter, tight enough that real blocking work
# (a subprocess spawn, an API retry loop) under a data lock trips it.
LOCK_HOLD_OUTLIER_S = 5.0


@dataclass
class ChaosReport:
    seed: int
    events: int = 0
    prepares: int = 0
    unprepares: int = 0
    batches: int = 0                  # multi-claim prepare RPCs driven
    crashes: int = 0
    health_events: int = 0
    failed_attempts: int = 0          # operations a fault made fail
    injected: Dict[str, int] = field(default_factory=dict)
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "events": self.events,
                "prepares": self.prepares, "unprepares": self.unprepares,
                "batches": self.batches,
                "crashes": self.crashes, "health_events": self.health_events,
                "failed_attempts": self.failed_attempts,
                "injected": dict(self.injected),
                "violations": list(self.violations)}


def _corrupt_one_slot(rng: random.Random):
    """Armed action for checkpoint.corrupt: tear ONE of the slots the
    store just wrote (a real torn write hits the slot in flight)."""
    def action(paths=()):
        if not paths:
            return
        path = rng.choice(list(paths))
        try:
            with open(path, "r+b") as f:
                f.seek(0)
                f.write(b'{"torn":')  # valid JSON prefix, broken envelope
        except OSError:
            pass
    return action


class ChaosHarness:
    """One seeded schedule: a real node-driver stack + the random walk.
    `backend` is the seam for a real inventory (NVML on the card); by
    default the node is `gpus` fake H100s of one NVLink clique in MIG
    mode, so a claim may take a whole GPU or one of its MIG devices (the
    reference's chips and their subslices). A passed backend stays the
    caller's to close."""

    MAX_QUIESCE_RETRIES = 30

    # Class-level defaults so close() is safe on a partially built
    # harness (an __init__ failure still releases the witness/gates/tmp).
    driver: Optional[GpuDriver] = None
    state: Optional[DeviceState] = None
    cdi: Optional[CDIHandler] = None
    tmp = ""
    _witnessed = False

    def __init__(self, seed: int, *, gpus: int = 4, backend=None):
        # Witness BEFORE any stack lock exists: every Lock/RLock the
        # driver stack creates below joins the acquisition-order graph,
        # and quiesce asserts it stayed acyclic.
        lockwitness.install()
        self._witnessed = True
        # Under an enclosing install the graph predates this harness:
        # report only THIS walk's window.
        self._witness_snap = lockwitness.WITNESS.snapshot()
        # Open-span snapshot: quiesce asserts every span THIS walk began
        # was closed — a leaked sibling-test span must not fail this
        # harness, hence the window.
        self._trace_snap = trace.TRACER.open_ids()
        self.seed = seed
        self.rng = random.Random(seed)
        self.report = ChaosReport(seed=seed)
        # Gates for the whole harness lifetime: time-slicing configs are
        # part of the random claim mix; the health monitor THREAD is off
        # because the walk injects events synchronously at the driver
        # callback (deterministic, and no monitor join per crash — the
        # monitor's own pipeline has dedicated tests).
        self._gates = featuregates.Features.overrides_snapshot()
        try:
            featuregates.Features.set_from_string(
                "TimeSlicingSettings=true,NVMLDeviceHealthCheck=false")
            self.tmp = tempfile.mkdtemp(prefix=f"gpu-dra-chaos-{seed}-")
            self.cluster = FakeCluster()
            # Fast backoff: chaos turns the crank; wall-clock realism is
            # the schedule's job, not the sleep's.
            self.client = RetryingApiClient(
                self.cluster, max_attempts=4, base_delay=0.001,
                max_delay=0.01, rng=random.Random(seed ^ 0x5EED))
            self.backend = backend if backend is not None else FakeBackend([
                dataclasses.replace(g, mig_mode=True)
                for g in default_fake_gpus(gpus, clique_id="chaos")])
            self.gpu_indices = sorted(g.index for g in self.backend.gpus())
            self.n_gpus = len(self.gpu_indices)
            # uid -> claim object, by expected terminal state
            self.prepared: Dict[str, Dict] = {}  # last prepare succeeded
            self.pending: Dict[str, Dict] = {}   # attempted, not yet ready
            self._build_stack()
        except BaseException:
            # Partial init: close() tolerates missing stack pieces (class
            # defaults) and always releases gates/tmp/witness.
            self.close()
            raise

    # -- stack lifecycle ----------------------------------------------------

    def _build_stack(self) -> None:
        self.cdi = CDIHandler(os.path.join(self.tmp, "cdi"),
                              driver_root=os.path.join(self.tmp, "drv"))
        self.state = DeviceState(
            backend=self.backend, cdi=self.cdi,
            checkpoints=CheckpointManager(os.path.join(self.tmp, "plugin")),
            driver_name=GPU_DRIVER_NAME, node_name="chaos-node",
            ts_manager=TimeSlicingManager(self.backend),
            # The ladder engages under the walk's flap storms (window
            # far past any schedule's wall clock; threshold low enough
            # that _op_flap_storm deterministically graduates).
            quarantine_threshold=3, quarantine_window_s=300.0)
        self.driver = GpuDriver(
            state=self.state, client=self.client,
            driver_name=GPU_DRIVER_NAME, node_name="chaos-node",
            plugin_dir=os.path.join(self.tmp, "plugin"),
            registry_dir=os.path.join(self.tmp, "reg"))
        # publish_wait=0: under an armed API fault the initial publish
        # retries in the background; the walk must not block on it.
        self.driver.start(publish_wait=0)

    def _teardown_stack(self) -> None:
        """SIGKILL analog: stop threads/sockets and release fds, but do
        NOT unprepare or write any terminal state — recovery must come
        from what is on disk."""
        if self.driver is not None:
            self.driver.shutdown()
            self.driver = None
            self.state = None

    def crash_restart(self, max_attempts: int = 25) -> None:
        """Crash the plugin and bring it back up. Startup itself can hit
        armed faults (checkpoint load/store, CDI write) — a crash-looping
        pod retries until the fault clears, so does this. A schedule that
        fires on EVERY attempt (a hard outage) would crash-loop forever;
        after max_attempts the outage is declared over (faults disarmed,
        harvesting their counts) and the plugin comes up — what an
        operator fixing the node achieves."""
        self._teardown_stack()
        self.report.crashes += 1
        for _ in range(max_attempts):
            try:
                self._build_stack()
                return
            except Exception:  # noqa: BLE001 # drflow: swallow-ok[crash-looping restart under armed faults is the modeled outcome; report.crashes counts it]
                time.sleep(0.002)
        self._harvest_faults()
        FAULTS.reset()
        self._build_stack()

    def close(self) -> None:
        # Nested finally: a teardown failure must not skip the gate
        # restore, the tmpdir removal, or the witness uninstall.
        try:
            self._teardown_stack()
        finally:
            try:
                featuregates.Features.restore_overrides(self._gates)
            finally:
                if self.tmp:
                    shutil.rmtree(self.tmp, ignore_errors=True)
                if self._witnessed:
                    self._witnessed = False
                    lockwitness.uninstall()

    # -- claim plumbing -----------------------------------------------------

    def _used_gpus(self) -> set:
        used = set()
        for obj in list(self.prepared.values()) + list(self.pending.values()):
            used.update(obj["_chaos_gpus"])
        return used

    def make_claim(self, gpu_indices: List[int],
                   devices: Optional[List[str]] = None,
                   configs: Optional[List[Dict]] = None) -> Dict:
        devices = devices or [f"gpu-{i}" for i in gpu_indices]
        obj = self.cluster.create(RESOURCECLAIMS, {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": f"chaos-{self.seed}-"
                                 f"{self.rng.randrange(16**8):08x}",
                         "namespace": "default"},
            "spec": {"devices": {"requests": [{"name": "gpu"}]}},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": GPU_DRIVER_NAME,
                 "pool": "chaos-node", "device": d} for d in devices],
                "config": configs or []}}},
        })
        obj["_chaos_gpus"] = set(gpu_indices)
        return obj

    def attempt_prepare(self, obj: Dict) -> Optional[str]:
        """One kubelet-style NodePrepareResources attempt; returns the
        error string (fault surfaced) or None (ready)."""
        claim = Claim(uid=obj["metadata"]["uid"],
                      name=obj["metadata"]["name"],
                      namespace=obj["metadata"]["namespace"])
        self.report.prepares += 1
        try:
            res = self.driver.prepare_claims([claim])[claim.uid]
        except Exception as e:  # noqa: BLE001 — fault escaped as exception
            return str(e)
        return res.error or None

    def attempt_unprepare(self, obj: Dict) -> Optional[str]:
        claim = Claim(uid=obj["metadata"]["uid"],
                      name=obj["metadata"]["name"],
                      namespace=obj["metadata"]["namespace"])
        self.report.unprepares += 1
        try:
            err = self.driver.unprepare_claims([claim])[claim.uid]
        except Exception as e:  # noqa: BLE001
            return str(e)
        return err or None

    # -- the random walk ----------------------------------------------------

    def _random_schedule(self) -> Schedule:
        kind = self.rng.choice(("nth", "prob", "oneshot"))
        if kind == "nth":
            return EveryNth(self.rng.randint(1, 4))
        if kind == "prob":
            return Probabilistic(self.rng.uniform(0.2, 0.7),
                                 random.Random(self.rng.randrange(1 << 30)))
        return OneShot(after=self.rng.randint(0, 3))

    def _harvest_faults(self) -> None:
        """Fold fired counters into the report (and zero them) before
        anything disarms or re-arms sites."""
        for site, fired in FAULTS.take_counts().items():
            self.report.injected[site] = (
                self.report.injected.get(site, 0) + fired)

    def _op_rearm(self) -> None:
        self._harvest_faults()
        site = self.rng.choice(CHAOS_SITES)
        if self.rng.random() < 0.3:
            FAULTS.disarm(site)
            return
        action = (_corrupt_one_slot(self.rng)
                  if site == "checkpoint.corrupt" else None)
        FAULTS.arm(site, self._random_schedule(), action=action)

    def _op_prepare_new(self) -> None:
        free = sorted(set(self.gpu_indices) - self._used_gpus())
        if not free:
            return
        n = self.rng.randint(1, min(2, len(free)))
        picked = self.rng.sample(free, n)
        devices = configs = None
        roll = self.rng.random()
        if roll < 0.2 and n == 1:
            # MIG claim: any allocatable device backed by the GPU (the
            # whole GPU or one of its MIG devices).
            names = sorted(name for name, d in self.state.allocatable.items()
                           if d.gpu.index == picked[0])
            devices = [self.rng.choice(names)]
        elif roll < 0.4:
            configs = TS_CONFIG
        obj = self.make_claim(picked, devices=devices, configs=configs)
        err = self.attempt_prepare(obj)
        uid = obj["metadata"]["uid"]
        if err is None:
            self.prepared[uid] = obj
        else:
            self.report.failed_attempts += 1
            self.pending[uid] = obj

    def _op_prepare_batch(self) -> None:
        """Kubelet-style multi-claim RPC: several single-GPU claims
        through ONE driver.prepare_claims call — the group-commit path —
        with per-claim outcome tracking (a faulted member lands in
        pending while its batch siblings land in prepared)."""
        free = sorted(set(self.gpu_indices) - self._used_gpus())
        if len(free) < 2:
            return
        n = self.rng.randint(2, min(3, len(free)))
        objs = [self.make_claim([c]) for c in self.rng.sample(free, n)]
        claims = [Claim(uid=o["metadata"]["uid"],
                        name=o["metadata"]["name"],
                        namespace=o["metadata"]["namespace"])
                  for o in objs]
        self.report.prepares += len(objs)
        self.report.batches += 1
        try:
            res = self.driver.prepare_claims(claims)
        except Exception as e:  # noqa: BLE001 — fault escaped as exception
            res = {c.uid: PrepareResult(error=str(e)) for c in claims}
        for obj in objs:
            uid = obj["metadata"]["uid"]
            r = res.get(uid)
            if r is not None and not r.error:
                self.prepared[uid] = obj
            else:
                self.report.failed_attempts += 1
                self.pending[uid] = obj

    def _op_retry_pending(self) -> None:
        if not self.pending:
            return
        uid = self.rng.choice(sorted(self.pending))
        obj = self.pending[uid]
        if obj.get("_chaos_unprepare"):
            # Mid-unprepare claim: kubelet never re-prepares a claim it
            # decided to release; keep driving it toward unallocated.
            if self.attempt_unprepare(obj) is None:
                self.pending.pop(uid)
            else:
                self.report.failed_attempts += 1
            return
        err = self.attempt_prepare(obj)
        if err is None:
            self.prepared[uid] = self.pending.pop(uid)
        else:
            self.report.failed_attempts += 1

    def _op_unprepare(self) -> None:
        pool = sorted(self.prepared) + sorted(self.pending)
        if not pool:
            return
        uid = self.rng.choice(pool)
        obj = self.prepared.get(uid) or self.pending.get(uid)
        err = self.attempt_unprepare(obj)
        if err is None:
            self.prepared.pop(uid, None)
            self.pending.pop(uid, None)
        else:
            self.report.failed_attempts += 1
            # Not cleanly unallocated yet: it must converge at quiesce.
            self.pending.setdefault(uid, self.prepared.pop(uid, obj))
            obj["_chaos_unprepare"] = True

    def _op_health(self) -> None:
        self.report.health_events += 1
        gpu = self.rng.choice(self.gpu_indices)
        if self.rng.random() < 0.4:
            event = HealthEvent(gpu_index=gpu, kind=RECOVERED_KIND, code=0)
        else:
            event = HealthEvent(gpu_index=gpu, kind="xid",
                                code=self.rng.choice(HEALTH_XIDS))
        self.driver._on_unhealthy_event(event)

    def _op_flap_storm(self) -> None:
        """Drive one GPU through the full quarantine ladder: threshold
        unhealthy/recovered flaps in a burst — with health.flap armed
        the graduation may be refused (degrading to transient-unhealthy
        and retrying on the next flap), which is exactly the path under
        test."""
        gpu = self.rng.choice(self.gpu_indices)
        for _ in range(3):
            self.driver._on_unhealthy_event(HealthEvent(
                gpu_index=gpu, kind="xid",
                code=self.rng.choice(HEALTH_XIDS)))
            self.driver._on_unhealthy_event(HealthEvent(
                gpu_index=gpu, kind=RECOVERED_KIND, code=0))
            self.report.health_events += 2

    def _op_clear_quarantine(self) -> None:
        """The operator's move: lift one random GPU's quarantine."""
        q = self.state.quarantined_gpus()
        if not q:
            return
        uuid = self.rng.choice(sorted(q))
        self.driver.clear_quarantine(q[uuid].get("gpu_index"))

    def run(self, n_events: int = 40) -> ChaosReport:
        ops = [(self._op_prepare_new, 4), (self._op_prepare_batch, 2),
               (self._op_retry_pending, 3),
               (self._op_unprepare, 2), (self._op_rearm, 2),
               (self.crash_restart, 1), (self._op_health, 1),
               (self._op_flap_storm, 1), (self._op_clear_quarantine, 1)]
        weighted = [op for op, w in ops for _ in range(w)]
        try:
            for _ in range(n_events):
                self.report.events += 1
                self.rng.choice(weighted)()
            self.quiesce_and_verify()
        finally:
            self._harvest_faults()
            FAULTS.reset()
            self.close()
        return self.report

    # -- quiesce + invariants -----------------------------------------------

    def quiesce_and_verify(self) -> None:
        self._harvest_faults()
        FAULTS.reset()
        v = self.report.violations

        # 1. Convergence: drive every in-flight claim to its terminal
        # state — the retry loop kubelet would run, minus the waiting.
        for uid in sorted(self.pending):
            obj = self.pending.pop(uid)
            to_unallocated = obj.get("_chaos_unprepare", False)
            err = last = None
            for _ in range(self.MAX_QUIESCE_RETRIES):
                last = (self.attempt_unprepare(obj) if to_unallocated
                        else self.attempt_prepare(obj))
                if last is None:
                    break
            else:
                err = last
            if err is not None:
                v.append(f"claim {uid} did not converge to "
                         f"{'unallocated' if to_unallocated else 'ready'} "
                         f"after faults cleared: {err}")
            elif not to_unallocated:
                self.prepared[uid] = obj

        # 2. Crash consistency: the terminal state must survive an
        # unclean restart (load_or_init + orphan GC path) — INCLUDING
        # the quarantine ledger: a crash must not launder a flapping GPU
        # back into the inventory.
        q_before = set(self.state.quarantined_gpus())
        self.crash_restart()
        q_after = set(self.state.quarantined_gpus())
        if q_before != q_after:
            v.append(f"quarantine did not survive restart: before "
                     f"{sorted(q_before)} after {sorted(q_after)}")

        snap = self.state.checkpoint_snapshot()
        want = set(self.prepared)

        # 3. No leaked checkpoint entries / lost claims.
        got = set(snap.claims)
        if got != want:
            v.append(f"checkpoint claims {sorted(got)} != expected "
                     f"prepared {sorted(want)}")
        for uid, pc in snap.claims.items():
            if pc.state != PREPARE_COMPLETED:
                v.append(f"claim {uid} left in state {pc.state} "
                         "after quiesce")

        # 4. No orphaned CDI spec files.
        specs = set(self.cdi.list_claim_uids())
        if specs != want:
            v.append(f"CDI claim specs {sorted(specs)} != expected "
                     f"{sorted(want)}")

        # 5. Idempotent re-prepare returns the same devices.
        for uid, obj in sorted(self.prepared.items()):
            err = self.attempt_prepare(obj)
            if err is not None:
                v.append(f"re-prepare of converged claim {uid} "
                         f"errored: {err}")

        # 6. ResourceSlice matches the healthy-GPU device set.
        try:
            self.driver.publish_resources()
            slices = self.cluster.list(RESOURCESLICES)
            published = {d["name"] for s in slices
                         for d in s["spec"].get("devices", [])}
            healthy = {d["name"] for d in self.state.healthy_devices()}
            if published != healthy:
                v.append(f"ResourceSlice devices {sorted(published)} != "
                         f"healthy set {sorted(healthy)}")
        except Exception as e:  # noqa: BLE001
            v.append(f"publish after quiesce failed: {e}")

        # 7. Full teardown: everything unprepares, zero residue.
        for uid, obj in sorted(self.prepared.items()):
            err = self.attempt_unprepare(obj)
            if err is not None:
                v.append(f"final unprepare of {uid} failed: {err}")
        self.prepared.clear()
        if self.cdi.list_claim_uids():
            v.append("CDI specs left after full teardown: "
                     f"{self.cdi.list_claim_uids()}")
        if self.state.prepared_claim_uids():
            v.append("checkpoint entries left after full teardown: "
                     f"{self.state.prepared_claim_uids()}")

        # 8. Lock-order witness: the whole walk (prepare storms, crash
        # restarts, health events across watch/workqueue/RPC threads)
        # must leave an ACYCLIC acquisition-order graph and no data lock
        # held across outlier-length work.
        v.extend(lockwitness.WITNESS.violations_since(
            self._witness_snap, max_hold_s=LOCK_HOLD_OUTLIER_S))

        # 9. Trace completeness: every span this walk began — across
        # prepare storms, crash restarts (the prepare batch abandons
        # mid-crash spans), fault-aborted batches and the trace.emit
        # drop path — must be CLOSED at quiesce. An open span here is a
        # leaked attribution context.
        v.extend(trace.open_span_violations(self._trace_snap))


def run_schedule(seed: int, n_events: int = 40, gpus: int = 4) -> ChaosReport:
    """One seeded fault schedule to quiesce; the chaos tier's unit."""
    return ChaosHarness(seed, gpus=gpus).run(n_events)


def run_matrix(seeds: List[int], n_events: int = 40) -> Dict:
    reports = [run_schedule(seed, n_events) for seed in seeds]
    injected: Dict[str, int] = {}
    for r in reports:
        for site, n in r.injected.items():
            injected[site] = injected.get(site, 0) + n
    return {
        "schedules": len(reports),
        "events": sum(r.events for r in reports),
        "prepares": sum(r.prepares for r in reports),
        "batches": sum(r.batches for r in reports),
        "failed_attempts": sum(r.failed_attempts for r in reports),
        "crashes": sum(r.crashes for r in reports),
        "injected": injected,
        "violations": [f"seed {r.seed}: {msg}"
                       for r in reports for msg in r.violations],
    }


# ---------------------------------------------------------------------------
# Scheduler-churn walk (event-driven control plane under faults)
# ---------------------------------------------------------------------------

# Sites the scheduler walk may arm: API flakes and watch-stream drops hit
# the informer plane; sched.watch_event / sched.index_apply hit the
# scheduler's own event handling and incremental allocation index;
# sched.shard_apply dirties ONE shard of the sharded index (the
# shard-scoped resync path), and sched.snapshot_commit refuses
# optimistic commits (the multi-worker conflict/requeue path) — so the
# guarded resync fallback AND the parallel core's commit discipline are
# chaos-tested on the production path.
# sched.watch_shard_dispatch sheds deltas off the partitioned claims
# informer's shard FIFOs (the bounded-queue overflow path), and
# sched.informer_shard_relist faults the recovery hook itself — together
# they chaos-test the shard-dirty + resync pipeline that heals a shed
# delta, including its whole-index degradation.
SCHED_CHAOS_SITES = ("k8s.api.request", "k8s.watch.drop",
                     "sched.watch_event", "sched.index_apply",
                     "sched.shard_apply", "sched.snapshot_commit",
                     "sched.watch_shard_dispatch",
                     "sched.informer_shard_relist",
                     "trace.emit")


def chip_conflicts(claims: List[Dict]) -> List[str]:
    """Device double-allocations across allocated claims, with partition
    semantics: the same device twice, or a whole GPU plus any of its MIG
    devices, in DIFFERENT claims (the reference's name, kept). Asserted
    by the scheduler chaos walks at quiesce."""
    from tpu_dra_torch.simcluster.scheduler import (
        _parent_of, claim_entries, claim_key,
    )

    holders: Dict[tuple, List[str]] = {}     # (driver,pool,device) -> keys
    gpu_holders: Dict[tuple, List[tuple]] = {}  # (driver,pool,gpu) ->
    #                                             [(key, is_whole)]
    out = []
    for claim in claims:
        key = claim_key(claim)
        for driver, pool, dev in claim_entries(claim):
            holders.setdefault((driver, pool, dev), []).append(key)
            gpu = _parent_of(dev)  # the scheduler's own partition rule
            gpu_holders.setdefault((driver, pool, gpu), []).append(
                (key, gpu == dev))
    for ent, keys in sorted(holders.items()):
        if len(set(keys)) > 1:
            out.append(f"device {ent} allocated to {sorted(set(keys))}")
    for ent, users in sorted(gpu_holders.items()):
        whole = {k for k, is_whole in users if is_whole}
        migs = {k for k, is_whole in users if not is_whole}
        if whole and migs - whole:
            out.append(f"GPU {ent} wholly allocated to {sorted(whole)} "
                       f"while MIG devices go to {sorted(migs)}")
    return out


class SchedulerChaosHarness:
    """One seeded schedule against the EVENT-DRIVEN scheduler: a random
    walk of pod churn (create / delete), fault re-arming across
    SCHED_CHAOS_SITES, and forced resyncs, against a real Scheduler over
    a RetryingApiClient-wrapped FakeCluster with a deliberately tiny
    watch-event log (dropped streams hit real 410 relists). After the
    walk, faults are disarmed and the harness waits for convergence,
    then asserts:

    1. every live pod is bound, its claims allocated on its node;
    2. no device double-allocation (partition semantics included);
    3. no claim left behind by a dead pod (no leak after pod death);
    4. the incremental allocation index matches cluster truth.
    """

    QUIESCE_TIMEOUT = 30.0

    # Sites the walk's re-arm op may pick; subclasses extend (the
    # topology walk adds the data-plane handoff sites).
    REARM_SITES = SCHED_CHAOS_SITES

    def __init__(self, seed: int, *, nodes: int = 4, gpus_per_node: int = 2,
                 workers: int = 4):
        # Witness the scheduler's lock population (informer RLocks,
        # allocation-index lock, pending-set lock, rate-limiter locks):
        # quiesce asserts the acquisition-order graph stayed acyclic.
        lockwitness.install()
        self._witnessed = True
        self._witness_snap = lockwitness.WITNESS.snapshot()
        # Per-walk open-span window.
        self._trace_snap = trace.TRACER.open_ids()
        # View shadow: every zero-copy view the scheduler reads this
        # walk is content-hashed at hand-out; quiesce asserts none
        # drifted.
        self._shadow_prev = informer_mod.SHADOW.enable()
        self._shadow_snap = informer_mod.SHADOW.snapshot()
        self.seed = seed
        self.rng = random.Random(seed ^ 0x5C4ED)
        self.report = ChaosReport(seed=seed)
        self.nodes = nodes
        self.gpus = gpus_per_node
        self.capacity = nodes * gpus_per_node
        try:
            self.cluster = FakeCluster()
            self.cluster.EVENT_LOG_CAP = 48  # tight history: drops hit 410s
            self.client = RetryingApiClient(
                self.cluster, max_attempts=4, base_delay=0.001,
                max_delay=0.01, rng=random.Random(seed ^ 0xD15C))
            self._seed_inventory()
            # workers=4: the walk exercises the multi-worker pool — the
            # per-key serialization and optimistic snapshot-commit
            # disciplines are chaos invariants, not just bench wins.
            self._start_scheduler(workers)
            self.live: Dict[str, None] = {}
            self._pod_seq = 0
        except BaseException:
            # Anything after install() failing must release the witness
            # refcount, or threading.Lock stays patched process-wide
            # (and the view shadow must not stay enabled either).
            informer_mod.SHADOW.restore(self._shadow_prev)
            self._witnessed = False
            lockwitness.uninstall()
            raise

    def _seed_inventory(self) -> None:
        from tpu_dra_torch.testing import seed_sched_inventory
        seed_sched_inventory(self.cluster, nodes=self.nodes,
                             gpus_per_node=self.gpus)

    def _start_scheduler(self, workers: int) -> None:
        """Seam the HA walk overrides to run a replicated pair behind
        leader election instead of one always-acting scheduler."""
        from tpu_dra_torch.simcluster.scheduler import Scheduler
        self.sched = Scheduler(self.client, resync_interval=0.05,
                               gc_sweep_interval=0.2, workers=workers)
        self.sched.start()
        for inf in self.sched._informers.values():
            inf.RELIST_BACKOFF_BASE = 0.01  # keep the chaos tier fast

    # -- walk ops -----------------------------------------------------------

    def _random_schedule(self) -> Schedule:
        kind = self.rng.choice(("nth", "prob", "oneshot"))
        if kind == "nth":
            return EveryNth(self.rng.randint(1, 4))
        if kind == "prob":
            return Probabilistic(self.rng.uniform(0.1, 0.5),
                                 random.Random(self.rng.randrange(1 << 30)))
        return OneShot(after=self.rng.randint(0, 3))

    def _harvest_faults(self) -> None:
        for site, fired in FAULTS.take_counts().items():
            self.report.injected[site] = (
                self.report.injected.get(site, 0) + fired)

    def _op_rearm(self) -> None:
        self._harvest_faults()
        site = self.rng.choice(self.REARM_SITES)
        if self.rng.random() < 0.3:
            FAULTS.disarm(site)
            return
        FAULTS.arm(site, self._random_schedule())

    def _op_create_pod(self) -> None:
        if len(self.live) >= self.capacity:
            return  # keep the cluster satisfiable: quiesce expects binds
        from tpu_dra_torch.testing import make_sched_pod
        name = f"cp-{self.seed}-{self._pod_seq}"
        self._pod_seq += 1
        make_sched_pod(self.cluster, name)
        self.live[name] = None
        self.report.prepares += 1  # pod lifecycles driven

    def _op_delete_pod(self) -> None:
        if not self.live:
            return
        name = self.rng.choice(sorted(self.live))
        self.cluster.delete(PODS, name, "default")
        self.live.pop(name, None)
        self.report.unprepares += 1

    def _op_force_resync(self) -> None:
        self.sched.request_resync("chaos op")

    # -- run + invariants ---------------------------------------------------

    def _ops(self):
        """(op, weight) pairs of the walk; subclasses extend."""
        return [(self._op_create_pod, 4), (self._op_delete_pod, 2),
                (self._op_rearm, 2), (self._op_force_resync, 1)]

    def run(self, n_events: int = 60) -> ChaosReport:
        weighted = [op for op, w in self._ops() for _ in range(w)]
        try:
            for _ in range(n_events):
                self.report.events += 1
                self.rng.choice(weighted)()
                # Let the control plane breathe between ops; the walk is
                # about interleaving, not about starving the scheduler.
                time.sleep(self.rng.uniform(0.0, 0.004))
            self.quiesce_and_verify()
        finally:
            self._harvest_faults()
            FAULTS.reset()
            self.close()
        return self.report

    def _converged(self) -> List[str]:
        """Empty when the control plane reached the expected steady
        state; otherwise what is still wrong (the quiesce loop polls
        this until the deadline, then records it as violations)."""
        problems = []
        pods = {p["metadata"]["name"]: p
                for p in self.cluster.list(PODS, namespace="default")}
        claims = self.cluster.list(RESOURCECLAIMS, namespace="default")
        for name in sorted(self.live):
            pod = pods.get(name)
            if pod is None:
                problems.append(f"live pod {name} missing from cluster")
                continue
            node = pod["spec"].get("nodeName")
            if not node:
                problems.append(f"live pod {name} not bound")
                continue
            claim = next((c for c in claims
                          if (c["metadata"].get("annotations") or {}).get(
                              "sim/owner-pod") == name), None)
            if claim is None:
                problems.append(f"live pod {name} has no claim")
                continue
            entries = [r.get("pool") for r in
                       ((claim.get("status") or {}).get("allocation") or {})
                       .get("devices", {}).get("results", [])]
            if not entries:
                problems.append(f"claim of live pod {name} unallocated")
            elif set(entries) != {node}:
                problems.append(f"pod {name} bound to {node} but claim "
                                f"allocated on {sorted(set(entries))}")
        alive = set(self.live)
        for claim in claims:
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if owner and owner not in alive:
                problems.append(f"claim {claim['metadata']['name']} leaked "
                                f"after pod {owner} death")
        # Index health is part of convergence: a resync enqueued by the
        # walk's final ops may still be queued — asserting one-shot
        # after cluster-truth convergence would flag that transient as
        # a violation.
        if self.sched._index.dirty:
            problems.append("index dirty (resync pending)")
        else:
            problems.extend(self.sched.verify_index())
        return problems

    def quiesce_and_verify(self) -> None:
        self._harvest_faults()
        FAULTS.reset()
        v = self.report.violations
        deadline = time.monotonic() + self.QUIESCE_TIMEOUT
        problems = self._converged()
        while problems and time.monotonic() < deadline:
            time.sleep(0.02)
            problems = self._converged()
        v.extend(problems)
        # Hard invariants, on cluster truth after convergence:
        claims = self.cluster.list(RESOURCECLAIMS, namespace="default")
        v.extend(chip_conflicts(claims))
        v.extend(self.sched.verify_index())
        # Lock-order witness over the event-driven control plane: the
        # walk's informer/workqueue/worker interleavings must leave an
        # acyclic lock graph and no outlier-length data-lock hold.
        v.extend(lockwitness.WITNESS.violations_since(
            self._witness_snap, max_hold_s=LOCK_HOLD_OUTLIER_S))
        # Trace completeness: every Allocated claim must carry the
        # traceparent annotation the scheduler stamped in the allocation
        # write, and that trace must be a complete span tree — all spans
        # closed, parents precede children (a trace that lost a span to
        # the trace.emit fault skips structure but still owes zero open
        # spans). Then the walk-wide open-span sweep.
        for claim in claims:
            if not (claim.get("status") or {}).get("allocation"):
                continue
            tp = (claim["metadata"].get("annotations") or {}).get(
                trace.TRACEPARENT_ANNOTATION)
            parsed = trace.parse_traceparent(tp)
            if parsed is None:
                v.append(f"allocated claim {claim['metadata']['name']} "
                         f"carries no valid traceparent annotation "
                         f"({tp!r})")
                continue
            v.extend(trace.verify_trace(parsed[0]))
        v.extend(trace.open_span_violations(self._trace_snap))
        # View-shadow sweep: any zero-copy view mutated in place since
        # hand-out is a violation.
        v.extend(informer_mod.SHADOW.violations_since(self._shadow_snap))

    def _stop_scheduler(self) -> None:
        """Seam paired with _start_scheduler (HA walk stops a pair)."""
        self.sched.stop()

    def close(self) -> None:
        try:
            self._stop_scheduler()
        finally:
            informer_mod.SHADOW.export()
            informer_mod.SHADOW.restore(self._shadow_prev)
            if self._witnessed:
                self._witnessed = False
                lockwitness.uninstall()


def run_sched_schedule(seed: int, n_events: int = 60) -> ChaosReport:
    """One seeded scheduler-churn walk to quiesce."""
    return SchedulerChaosHarness(seed).run(n_events)


# ---------------------------------------------------------------------------
# HA leader-kill walk
# ---------------------------------------------------------------------------

# The election/takeover sites the leader-kill walk re-arms on top of the
# scheduler set: renew failures depose leaders mid-churn, takeover-resync
# faults force the promote degradation (queued re-resync, dirty shards
# refusing commits).
HA_CHAOS_SITES = ("sched.lease_renew", "sched.takeover_resync")


class LeaderKillChaosHarness(SchedulerChaosHarness):
    """The scheduler walk replicated: two Scheduler replicas behind
    LeaderElectors over one fenced Lease, plus walk ops that kill the
    acting leader cold (no lease release — the standby must wait out
    expiry, CAS the takeover, resync, resume) and kill/revive nodes so
    takeovers race pod churn AND eviction. Each kill refills the slot
    with a fresh standby under a NEW identity, so every kill is a
    genuine expiry-takeover, and the walk keeps a 2-replica pool
    throughout. Invariants on top of the base set: at most one acting
    leader at quiesce, and — via the fencing reactor — no deposed
    leader's late commit landing (it would surface as double allocation
    / index divergence)."""

    REARM_SITES = SCHED_CHAOS_SITES + HA_CHAOS_SITES
    LEASE_DURATION_S = 0.3

    def _start_scheduler(self, workers: int) -> None:
        from tpu_dra_torch.infra.leaderelect import install_fencing
        install_fencing(self.cluster)
        self._ha_workers = workers
        self._incarnation = 0
        self._replicas: List = [None, None]
        self._electors: List = [None, None]
        self.dead_nodes: Dict[str, Dict] = {}
        self.leader_kills = 0
        for slot in range(2):
            self._spawn_replica(slot)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if any(s is not None and not s.is_standby
                   for s in self._replicas):
                return  # steady state: an acting leader exists
            time.sleep(0.005)
        raise RuntimeError("no replica became acting leader at startup")

    @property
    def sched(self):
        """The acting replica (the base walk's invariants read index
        state through this); mid-takeover, whichever replica exists."""
        for s in self._replicas:
            if s is not None and not s.is_standby:
                return s
        return next(s for s in self._replicas if s is not None)

    def _spawn_replica(self, slot: int) -> None:
        from tpu_dra_torch.infra.leaderelect import LeaderElector
        from tpu_dra_torch.simcluster.scheduler import Scheduler
        sched = Scheduler(self.client, resync_interval=0.05,
                          gc_sweep_interval=0.2, workers=self._ha_workers)
        sched.start(standby=True)
        for inf in sched._informers.values():
            inf.RELIST_BACKOFF_BASE = 0.01
        self._incarnation += 1
        ident = f"rep{slot}-{self._incarnation}"

        def on_started(gen, s=sched):
            s.set_lease_generation(gen)
            s.promote()

        elector = LeaderElector(
            self.client, ident,
            lease_duration_s=self.LEASE_DURATION_S,
            renew_interval_s=0.08,
            on_started_leading=on_started,
            seed=self.seed * 101 + self._incarnation)
        self._replicas[slot] = sched
        self._electors[slot] = elector
        elector.start()

    def _op_kill_leader(self) -> None:
        """Kill the acting leader cold, racing whatever churn/eviction
        is in flight, and refill the slot with a fresh standby."""
        idx = next((i for i, el in enumerate(self._electors)
                    if el is not None and el.is_leader), None)
        if idx is None:
            return  # mid-takeover: no acting leader to kill
        self._electors[idx].stop()
        self._replicas[idx].stop()
        self.report.crashes += 1
        self.leader_kills += 1
        self._spawn_replica(idx)

    def _op_kill_node(self) -> None:
        """Node death feeding the eviction scan (so takeovers race
        eviction, not just churn); at least half the fleet survives."""
        alive = sorted(n["metadata"]["name"]
                       for n in self.cluster.list(NODES))
        if len(alive) <= max(1, self.nodes // 2):
            return
        name = self.rng.choice(alive)
        node_obj = next(n for n in self.cluster.list(NODES)
                        if n["metadata"]["name"] == name)
        slices = [sl for sl in self.cluster.list(RESOURCESLICES)
                  if (sl.get("spec") or {}).get("nodeName") == name]
        strip = NodeDeathChaosHarness._strip_meta
        self.dead_nodes[name] = {
            "node": strip(node_obj),
            "slices": [strip(sl) for sl in slices]}
        for sl in slices:
            self.cluster.delete(RESOURCESLICES, sl["metadata"]["name"],
                                None)
        self.cluster.delete(NODES, name, None)

    def _op_revive_node(self) -> None:
        if not self.dead_nodes:
            return
        name = self.rng.choice(sorted(self.dead_nodes))
        saved = self.dead_nodes.pop(name)
        self.cluster.create(NODES, saved["node"])
        for sl in saved["slices"]:
            self.cluster.create(RESOURCESLICES, sl)

    def _ops(self):
        return super()._ops() + [(self._op_kill_leader, 2),
                                 (self._op_kill_node, 1),
                                 (self._op_revive_node, 1)]

    def quiesce_and_verify(self) -> None:
        # Revive the whole fleet first: quiesce owes every live pod a
        # bind, which needs the seeded capacity back (evicted claims
        # re-drive onto the restored nodes).
        for name in sorted(self.dead_nodes):
            saved = self.dead_nodes[name]
            self.cluster.create(NODES, saved["node"])
            for sl in saved["slices"]:
                self.cluster.create(RESOURCESLICES, sl)
        self.dead_nodes.clear()
        super().quiesce_and_verify()
        acting = [el.identity for el in self._electors
                  if el is not None and el.is_leader]
        if len(acting) > 1:
            self.report.violations.append(
                f"two acting leaders at quiesce: {sorted(acting)}")

    def _stop_scheduler(self) -> None:
        for elector in self._electors:
            if elector is not None:
                elector.stop()
        for sched in self._replicas:
            if sched is not None:
                sched.stop()


def run_leaderkill_schedule(seed: int, n_events: int = 60) -> ChaosReport:
    """One seeded leader-kill walk to quiesce."""
    return LeaderKillChaosHarness(seed).run(n_events)


def run_leaderkill_matrix(seeds: List[int], n_events: int = 60) -> Dict:
    return _pod_matrix_summary(
        [run_leaderkill_schedule(seed, n_events) for seed in seeds])


# ---------------------------------------------------------------------------
# Topology walk (contiguous multi-GPU allocation under churn + faults)
# ---------------------------------------------------------------------------

# Claim sizes the topology walk mixes (single-GPU heavy with a multi-GPU
# tail).
TOPO_CLAIM_SIZES = (1, 1, 2, 2, 4)

# Data-plane handoff sites the topology walk additionally arms:
# mesh.build fires inside meshexport.plan_from_* (the allocation ->
# MeshPlan constructor the workload's mesh builder runs), and
# workload.launch inside the launch-admission seam. The walk's mesh
# probe keeps exercising both against live allocations, so the refusal
# paths are chaos-tested, and quiesce asserts that with faults disarmed
# every allocated multi-GPU claim still yields a contiguous plan.
MESH_CHAOS_SITES = ("mesh.build", "workload.launch")


class TopologyChaosHarness(SchedulerChaosHarness):
    """The scheduler walk with the TopologyAwareScheduling gate ON over
    a coordinate-publishing inventory (4 nodes x 8 GPUs, two nodes per
    NVLink clique), churning a mix of 1/2/4-GPU pods. On top of the base
    invariants, after quiesce:

    5. every allocated multi-GPU claim is a contiguous block;
    6. the topology free-set derived from the allocation index exactly
       matches the one derived from cluster truth
       (Scheduler.verify_topology).

    In-flight GPU load is capped below capacity so quiesce stays
    satisfiable: the topology path deliberately REFUSES non-contiguous
    placements, and a walk pinned at 100% utilization could wedge a
    final multi-GPU pod behind fragmentation no future free will clear
    (no deletes happen after the walk).

    7. (data-plane handoff) every allocated multi-GPU claim on the
       coordinate-publishing inventory yields a MeshPlan — contiguous,
       with a positive modeled NVLink bandwidth — once faults are
       disarmed; during the walk the probe op keeps building plans with
       mesh.build/workload.launch armed, so refusals surface as
       FaultInjected (counted), never as a wrong mesh."""

    REARM_SITES = SCHED_CHAOS_SITES + MESH_CHAOS_SITES
    NODES_PER_CLIQUE = 2

    def __init__(self, seed: int, *, nodes: int = 4,
                 gpus_per_node: int = 8):
        self._topo_gates = featuregates.Features.overrides_snapshot()
        featuregates.Features.set_from_string("TopologyAwareScheduling=true")
        try:
            super().__init__(seed, nodes=nodes,
                             gpus_per_node=gpus_per_node)
        except Exception:
            featuregates.Features.restore_overrides(self._topo_gates)
            raise
        self.pod_gpus: Dict[str, int] = {}
        self.gpu_budget = (self.capacity * 3) // 4
        # The mid-walk mesh probe picks among the claims allocated at
        # that moment, which depends on the scheduler's timing: it draws
        # from an rng of its own so the walk's op sequence stays set by
        # the seed alone.
        self._probe_rng = random.Random(seed ^ 0x9E5B)

    def _seed_inventory(self) -> None:
        from tpu_dra_torch.testing import seed_sched_inventory
        seed_sched_inventory(self.cluster, nodes=self.nodes,
                             gpus_per_node=self.gpus,
                             nodes_per_clique=self.NODES_PER_CLIQUE,
                             claim_counts=(2, 4))

    def _op_create_pod(self) -> None:
        n = self.rng.choice(TOPO_CLAIM_SIZES)
        if sum(self.pod_gpus.values()) + n > self.gpu_budget:
            return
        from tpu_dra_torch.testing import make_sched_pod
        name = f"tp-{self.seed}-{self._pod_seq}"
        self._pod_seq += 1
        make_sched_pod(self.cluster, name,
                       template="tmpl" if n == 1 else f"tmpl{n}")
        self.live[name] = None
        self.pod_gpus[name] = n
        self.report.prepares += 1

    def _op_delete_pod(self) -> None:
        if not self.live:
            return
        name = self.rng.choice(sorted(self.live))
        self.cluster.delete(PODS, name, "default")
        self.live.pop(name, None)
        self.pod_gpus.pop(name, None)
        self.report.unprepares += 1

    def _free_blocks(self, alive: Optional[set] = None) -> List[tuple]:
        """(NodeTopology, free coordinates) for each node publishing a
        topology (of `alive` nodes, when given), against cluster truth:
        a GPU is taken when a claim of a LIVE pod holds it or one of its
        MIG devices. A dead pod's claim is not counted: GC will free its
        GPUs, and counting them could prune (or call unplaceable) a pod
        the scheduler will legitimately place once the drain
        completes."""
        from tpu_dra_torch.simcluster.scheduler import (
            _parent_of, claim_entries,
        )
        from tpu_dra_torch.topology import placement

        pods = {p["metadata"]["name"]
                for p in self.cluster.list(PODS, namespace="default")}
        taken: Dict[str, set] = {}
        for claim in self.cluster.list(RESOURCECLAIMS,
                                       namespace="default"):
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if owner and owner not in pods:
                continue  # GC will free these
            for _drv, pool, dev in claim_entries(claim):
                taken.setdefault(pool, set()).add(_parent_of(dev))
        out = []
        for sl in self.cluster.list(RESOURCESLICES):
            node = (sl.get("spec") or {}).get("nodeName")
            if not node or (alive is not None and node not in alive):
                continue
            topo = placement.node_topology_from_slices([sl])
            if topo is None:
                continue
            out.append((topo, {c for dev, c in topo.coord_of.items()
                               if dev not in taken.get(node, set())}))
        return out

    @staticmethod
    def _fits(blocks: List[tuple], n_gpus: int) -> bool:
        from tpu_dra_torch.topology import placement
        return any(placement.best_placement(topo.fabric, free, n_gpus)
                   is not None for topo, free in blocks)

    def _prune_wedged(self) -> None:
        """Strict gate-on semantics can leave a pod PROVABLY
        unplaceable at quiesce: no node's remaining free coordinate set
        admits a contiguous block of its size, and with the walk over
        no delete will ever free one (free sets only shrink). That is
        the documented wait-for-capacity behavior, not a scheduler bug
        — delete such pods (the operator's move) instead of letting the
        convergence deadline record a false violation. Pruning requires
        proof: every node rejects the pod's count against cluster-truth
        free sets (a dead pod's claim counts as free, see _free_blocks).
        Called from the convergence poll, so a pod that becomes provably
        wedged only after a sibling allocates is still caught."""
        unbound = []
        pods = {p["metadata"]["name"]: p
                for p in self.cluster.list(PODS, namespace="default")}
        for name in sorted(self.live):
            pod = pods.get(name)
            if pod is not None and not pod["spec"].get("nodeName"):
                unbound.append(name)
        if not unbound:
            return
        blocks = self._free_blocks()
        for name in unbound:
            n = self.pod_gpus.get(name, 1)
            if self._fits(blocks, n):
                continue  # placeable: let the scheduler get there
            self.cluster.delete(PODS, name, "default")
            self.live.pop(name, None)
            self.pod_gpus.pop(name, None)
            self.report.unprepares += 1
            log.info("topology chaos: pruned provably-unplaceable pod %s "
                     "(%d GPUs, fragmentation wedge)", name, n)

    def _ops(self):
        return super()._ops() + [(self._op_mesh_probe, 2)]

    def _allocated_multigpu_claims(self) -> List[Dict]:
        return [c for c in self.cluster.list(RESOURCECLAIMS,
                                             namespace="default")
                if len((((c.get("status") or {}).get("allocation") or {})
                        .get("devices") or {}).get("results") or []) >= 2]

    def _op_mesh_probe(self) -> None:
        """Build a MeshPlan from one live allocation + admit a launch,
        with whatever faults the walk armed: the data-plane handoff's
        production guards (mesh.build, workload.launch) fire here, and
        an injected fault must surface as FaultInjected — a refusal the
        workload retries — never as a silently mis-ordered mesh."""
        from tpu_dra_torch.infra.faults import FaultInjected
        from tpu_dra_torch.topology import meshexport

        claims = self._allocated_multigpu_claims()
        if not claims:
            return
        claim = self._probe_rng.choice(sorted(
            claims, key=lambda c: c["metadata"]["name"]))
        slices = self.cluster.list(RESOURCESLICES)
        try:
            plan = meshexport.plan_from_allocation(claim, slices)
            meshexport.admit_launch("allreduce")
        except FaultInjected:
            return  # counted via FAULTS.take_counts at harvest
        except meshexport.MeshBuildError as e:
            # A racing deallocation can momentarily list a claim whose
            # slices moved; quiesce re-checks with the world stopped,
            # so only repeated failure there is a violation.
            log.info("topology chaos: mid-walk mesh probe refused: %s", e)
            return
        if not plan.contiguous:
            self.report.violations.append(
                f"mesh probe: claim {claim['metadata']['name']} built a "
                f"non-contiguous plan on the gate-on inventory "
                f"(coords {list(plan.coords)})")

    def _verify_mesh_handoff(self) -> List[str]:
        """Quiesce invariant 7: faults disarmed, every allocated
        multi-GPU claim must yield a contiguous MeshPlan with positive
        modeled NVLink bandwidth."""
        from tpu_dra_torch.topology import meshexport

        out: List[str] = []
        slices = self.cluster.list(RESOURCESLICES)
        for claim in self._allocated_multigpu_claims():
            name = claim["metadata"]["name"]
            try:
                plan = meshexport.plan_from_allocation(claim, slices)
            except Exception as e:  # noqa: BLE001 — any failure is a finding
                out.append(f"mesh handoff: claim {name} yields no plan: {e}")
                continue
            if not plan.contiguous:
                out.append(f"mesh handoff: claim {name} plan is not a "
                           f"contiguous block (coords {list(plan.coords)})")
            if plan.modeled_nvlink_gbps <= 0:
                out.append(f"mesh handoff: claim {name} modeled NVLink "
                           f"bandwidth is {plan.modeled_nvlink_gbps}")
        return out

    def _converged(self) -> List[str]:
        self._prune_wedged()
        return super()._converged()

    def quiesce_and_verify(self) -> None:
        super().quiesce_and_verify()
        self.report.violations.extend(self.sched.verify_topology())
        self.report.violations.extend(self._verify_mesh_handoff())

    def close(self) -> None:
        try:
            super().close()
        finally:
            featuregates.Features.restore_overrides(self._topo_gates)


def run_topo_schedule(seed: int, n_events: int = 60) -> ChaosReport:
    """One seeded topology walk to quiesce."""
    return TopologyChaosHarness(seed).run(n_events)


# ---------------------------------------------------------------------------
# Node-death walk (failure-domain recovery racing pod churn)
# ---------------------------------------------------------------------------

class NodeDeathChaosHarness(TopologyChaosHarness):
    """The topology walk plus the classic production failure: hardware
    dies mid-traffic. The walk kills nodes (Node + ResourceSlices gone),
    quarantines GPUs (the slice shrinks, the driver-republish analog),
    revives both, and arms ``sched.evict`` on top of the scheduler
    sites — while pods churn. The control plane must CONVERGE, not
    wedge; after quiesce:

    8. no claim is allocated to a dead node or an unpublished (dead /
       quarantined) device;
    9. every live pod is either bound with its claim Allocated on live
       published GPUs, or — when no placement exists on the surviving
       topology — Pending WITH a recorded PodScheduled=False reason
       (strict topology refusal, never a silent shrink or hang);
    10. a pod that IS placeable on the surviving capacity gets placed
       (eviction re-drives, the strict-refusal path does not leak pods).

    Pruning is OFF in this walk: provably-unplaceable pods are the
    invariant (Pending-with-reason), not noise to delete. Every op draws
    from the walk's rng in a way that depends on the walk's own state
    only (the mesh probe has its own rng), so which nodes die, and when,
    is set by the seed.
    """

    REARM_SITES = TopologyChaosHarness.REARM_SITES + ("sched.evict",)

    # Claim sizes: single-GPU heavy so dead capacity rarely wedges
    # everything, with a multi-GPU tail to exercise strict refusal.
    CLAIM_SIZES = (1, 1, 1, 2, 4)

    def __init__(self, seed: int, *, nodes: int = 4,
                 gpus_per_node: int = 8):
        super().__init__(seed, nodes=nodes, gpus_per_node=gpus_per_node)
        # name -> saved {"node": obj, "slices": [objs]} for revival.
        self.dead_nodes: Dict[str, Dict] = {}
        # node -> {device name: saved device obj} (quarantined GPUs).
        self.dead_gpus: Dict[str, Dict[str, Dict]] = {}

    # -- capacity bookkeeping ------------------------------------------------

    def _published(self) -> Dict[str, set]:
        out: Dict[str, set] = {}
        for sl in self.cluster.list(RESOURCESLICES):
            node = (sl.get("spec") or {}).get("nodeName")
            if node:
                out.setdefault(node, set()).update(
                    d["name"] for d in sl["spec"].get("devices", []))
        return out

    def _nodes_alive(self) -> set:
        return {n["metadata"]["name"] for n in self.cluster.list(NODES)}

    def _op_create_pod(self) -> None:
        # Budget against LIVE capacity, not the seeded total — a walk
        # that killed half the fleet must stop admitting at half rate.
        alive = self._nodes_alive()
        live = sum(len(devs) for node, devs in self._published().items()
                   if node in alive)
        self.gpu_budget = (live * 3) // 4
        n = self.rng.choice(self.CLAIM_SIZES)
        if sum(self.pod_gpus.values()) + n > self.gpu_budget:
            return
        from tpu_dra_torch.testing import make_sched_pod
        name = f"nd-{self.seed}-{self._pod_seq}"
        self._pod_seq += 1
        make_sched_pod(self.cluster, name,
                       template="tmpl" if n == 1 else f"tmpl{n}")
        self.live[name] = None
        self.pod_gpus[name] = n
        self.report.prepares += 1

    # -- failure-domain ops --------------------------------------------------

    @staticmethod
    def _strip_meta(obj: Dict) -> Dict:
        from tpu_dra_torch.k8s.client import json_deepcopy
        out = json_deepcopy(obj)
        for key in ("resourceVersion", "uid", "creationTimestamp"):
            out["metadata"].pop(key, None)
        return out

    def _op_kill_node(self) -> None:
        """Node death: the Node object AND its ResourceSlices vanish
        (kubelet gone, slice GC done). At least half the fleet stays
        alive so quiesce retains surviving capacity to re-drive onto."""
        candidates = sorted(self._nodes_alive())
        if len(candidates) <= max(1, self.nodes // 2):
            return
        name = self.rng.choice(candidates)
        node_obj = next(n for n in self.cluster.list(NODES)
                        if n["metadata"]["name"] == name)
        slices = [sl for sl in self.cluster.list(RESOURCESLICES)
                  if (sl.get("spec") or {}).get("nodeName") == name]
        self.dead_nodes[name] = {
            "node": self._strip_meta(node_obj),
            "slices": [self._strip_meta(sl) for sl in slices]}
        for sl in slices:
            self.cluster.delete(RESOURCESLICES, sl["metadata"]["name"],
                                None)
        self.cluster.delete(NODES, name, None)
        self.report.crashes += 1
        log.info("node-death chaos: killed node %s", name)

    def _op_revive_node(self) -> None:
        if not self.dead_nodes:
            return
        name = self.rng.choice(sorted(self.dead_nodes))
        saved = self.dead_nodes.pop(name)
        self.cluster.create(NODES, saved["node"])
        for sl in saved["slices"]:
            self.cluster.create(RESOURCESLICES, sl)
        log.info("node-death chaos: revived node %s", name)

    def _op_quarantine_gpu(self) -> None:
        """The driver-quarantine republish analog: one whole GPU drops
        out of its node's published ResourceSlice."""
        alive = sorted(self._nodes_alive())
        if not alive:
            return
        node = self.rng.choice(alive)
        for sl in self.cluster.list(RESOURCESLICES):
            if (sl.get("spec") or {}).get("nodeName") != node:
                continue
            devices = sl["spec"].get("devices", [])
            if len(devices) <= 1:
                return  # keep the node publishing something
            dev = self.rng.choice(sorted(d["name"] for d in devices))
            saved = next(d for d in devices if d["name"] == dev)
            sl["spec"]["devices"] = [d for d in devices
                                     if d["name"] != dev]
            self.cluster.update(RESOURCESLICES, sl)
            self.dead_gpus.setdefault(node, {})[dev] = saved
            self.report.health_events += 1
            return

    def _op_restore_gpu(self) -> None:
        nodes = [n for n in sorted(self.dead_gpus)
                 if n in self._nodes_alive() and self.dead_gpus[n]]
        if not nodes:
            return
        node = self.rng.choice(nodes)
        dev = self.rng.choice(sorted(self.dead_gpus[node]))
        saved = self.dead_gpus[node].pop(dev)
        for sl in self.cluster.list(RESOURCESLICES):
            if (sl.get("spec") or {}).get("nodeName") != node:
                continue
            sl["spec"]["devices"] = sorted(
                sl["spec"].get("devices", []) + [saved],
                key=lambda d: d["name"])
            self.cluster.update(RESOURCESLICES, sl)
            return

    def _ops(self):
        return super()._ops() + [
            (self._op_kill_node, 2), (self._op_revive_node, 1),
            (self._op_quarantine_gpu, 2), (self._op_restore_gpu, 1)]

    # -- convergence ---------------------------------------------------------

    def _placeable(self, n_gpus: int, alive: set) -> bool:
        """Can a contiguous n-GPU block be placed on ANY live node's
        free coordinates (claims of LIVE pods taken; dead pods' claims
        drain via GC)? The same proof _prune_wedged runs — here it
        decides whether Pending-with-reason is legitimate."""
        return self._fits(self._free_blocks(alive), n_gpus)

    def _converged(self) -> List[str]:
        from tpu_dra_torch.simcluster.scheduler import claim_entries

        problems = []
        pods = {p["metadata"]["name"]: p
                for p in self.cluster.list(PODS, namespace="default")}
        claims = self.cluster.list(RESOURCECLAIMS, namespace="default")
        published = self._published()
        alive = self._nodes_alive()
        by_owner = {}
        for claim in claims:
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if owner:
                by_owner[owner] = claim
        for name in sorted(self.live):
            pod = pods.get(name)
            if pod is None:
                problems.append(f"live pod {name} missing from cluster")
                continue
            claim = by_owner.get(name)
            node = pod["spec"].get("nodeName")
            entries = claim_entries(claim) if claim else ()
            if node:
                if not entries:
                    problems.append(f"bound pod {name} claim unallocated")
                    continue
                if {e[1] for e in entries} != {node}:
                    problems.append(
                        f"pod {name} bound to {node} but claim on "
                        f"{sorted({e[1] for e in entries})}")
                if node not in alive:
                    problems.append(f"pod {name} bound to DEAD node "
                                    f"{node} (eviction missing)")
                dead = [e[2] for e in entries
                        if e[2] not in published.get(node, set())]
                if dead:
                    problems.append(
                        f"claim of pod {name} allocated to dead/"
                        f"quarantined devices {dead} on {node}")
            else:
                if entries:
                    # Mid-eviction or mid-bind: not converged yet.
                    problems.append(f"unbound pod {name} still holds an "
                                    "allocation")
                    continue
                if self._placeable(self.pod_gpus.get(name, 1), alive):
                    problems.append(f"pod {name} placeable on surviving "
                                    "capacity but still pending")
                    continue
                cond = next(
                    (c for c in (pod.get("status") or {}).get(
                        "conditions") or []
                     if c.get("type") == "PodScheduled"), None)
                if not (cond and cond.get("status") == "False"
                        and cond.get("reason")):
                    problems.append(f"pod {name} pending WITHOUT a "
                                    "recorded reason")
        alive_pods = set(self.live)
        for claim in claims:
            owner = (claim["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if owner and owner not in alive_pods:
                problems.append(f"claim {claim['metadata']['name']} "
                                f"leaked after pod {owner} death")
        if self.sched._index.dirty:
            problems.append("index dirty (resync pending)")
        else:
            problems.extend(self.sched.verify_index())
        return problems

    def quiesce_and_verify(self) -> None:
        # The base quiesce polls _converged (ours) then asserts
        # chip_conflicts/index/witness + topology/mesh invariants; on
        # top, the failure-domain hard invariant: NO allocated claim —
        # any claim, owned or not — references a dead node or an
        # unpublished device.
        super().quiesce_and_verify()
        from tpu_dra_torch.simcluster.scheduler import claim_entries
        published = self._published()
        alive = self._nodes_alive()
        for claim in self.cluster.list(RESOURCECLAIMS,
                                       namespace="default"):
            for _drv, pool, dev in claim_entries(claim):
                if pool not in alive:
                    self.report.violations.append(
                        f"claim {claim['metadata']['name']} allocated "
                        f"on dead node {pool} at quiesce")
                elif dev not in published.get(pool, set()):
                    self.report.violations.append(
                        f"claim {claim['metadata']['name']} bound to "
                        f"unpublished device {dev} on {pool} at quiesce")


def run_nodedeath_schedule(seed: int, n_events: int = 60) -> ChaosReport:
    """One seeded node-death-racing-churn walk to quiesce."""
    return NodeDeathChaosHarness(seed).run(n_events)


def run_nodedeath_matrix(seeds: List[int], n_events: int = 60) -> Dict:
    return _pod_matrix_summary(
        [run_nodedeath_schedule(seed, n_events) for seed in seeds])


def run_topo_matrix(seeds: List[int], n_events: int = 60) -> Dict:
    return _pod_matrix_summary(
        [run_topo_schedule(seed, n_events) for seed in seeds])


def _pod_matrix_summary(reports: List[ChaosReport]) -> Dict:
    """Aggregate a pod-churn walk matrix (scheduler + topology walks
    share this shape: prepares/unprepares count pod lifecycles)."""
    injected: Dict[str, int] = {}
    for r in reports:
        for site, n in r.injected.items():
            injected[site] = injected.get(site, 0) + n
    return {
        "schedules": len(reports),
        "events": sum(r.events for r in reports),
        "pod_creates": sum(r.prepares for r in reports),
        "pod_deletes": sum(r.unprepares for r in reports),
        "injected": injected,
        "violations": [f"seed {r.seed}: {msg}"
                       for r in reports for msg in r.violations],
    }


def run_sched_matrix(seeds: List[int], n_events: int = 60) -> Dict:
    return _pod_matrix_summary(
        [run_sched_schedule(seed, n_events) for seed in seeds])


# ---------------------------------------------------------------------------
# Dropped-watch + API-flake scenario
# ---------------------------------------------------------------------------

def run_watch_flake_scenario(seed: int = 0, n_objects: int = 30,
                             timeout: float = 10.0) -> List[str]:
    """An informer over the retrying client while the watch stream keeps
    dying and API requests flake: after faults clear, the cache must
    match cluster truth with NO manual relist — the resilient watch's
    RV-resume and the informer's 410-relist path do all the recovery.
    Returns violations (empty = recovered)."""
    violations: List[str] = []
    rng = random.Random(seed)
    cluster = FakeCluster()
    cluster.EVENT_LOG_CAP = 16  # tight history: dropped resumes hit 410s
    client = RetryingApiClient(cluster, max_attempts=4, base_delay=0.001,
                               max_delay=0.01,
                               rng=random.Random(seed ^ 0xF1A3))
    inf = Informer(client, PODS, namespace="default")
    inf.RELIST_BACKOFF_BASE = 0.01  # keep the chaos tier fast
    live: set = set()
    with FAULTS.armed("k8s.watch.drop", Probabilistic(0.2, rng)), \
         FAULTS.armed("k8s.api.request",
                      Probabilistic(0.25, random.Random(seed + 7))):
        inf.start()
        inf.wait_for_sync(timeout)
        for i in range(n_objects):
            name = f"p-{i}"
            cluster.create(PODS, {"apiVersion": "v1", "kind": "Pod",
                                  "metadata": {"name": name,
                                               "namespace": "default"}})
            live.add(name)
            if live and rng.random() < 0.3:
                victim = rng.choice(sorted(live))
                cluster.delete(PODS, victim, "default")
                live.discard(victim)
    # Quiesce (context managers disarmed the sites): cache must converge.
    try:
        deadline = time.monotonic() + timeout
        truth = {o["metadata"]["name"]
                 for o in cluster.list(PODS, namespace="default")}
        assert truth == live
        while time.monotonic() < deadline:
            cached = {o["metadata"]["name"] for o in inf.lister.list()}
            if cached == truth:
                break
            time.sleep(0.02)
        else:
            cached = {o["metadata"]["name"] for o in inf.lister.list()}
            violations.append(
                f"informer cache did not converge: cached-truth="
                f"{sorted(cached - truth)} truth-cached="
                f"{sorted(truth - cached)}")
    finally:
        inf.stop()
    return violations


# ---------------------------------------------------------------------------
# Crash-recovery latency probe (bench.bench_chaos_recovery)
# ---------------------------------------------------------------------------

def measure_daemon_crash_recovery(n: int = 7, seed: int = 1234,
                                  backend=None) -> Dict:
    """Median wall ms from an injected plugin-daemon crash to the
    affected claim prepared (ready) again: unclean teardown, full stack
    rebuild from disk (checkpoint load + orphan GC + standard CDI spec +
    DRA server + initial publish), then the idempotent re-prepare that
    hands kubelet the claim's devices back. The claim takes every GPU of
    the node and carries no config. `backend`: the node's inventory
    (NVML on the card); by default the harness's fake node."""
    h = ChaosHarness(seed, backend=backend)
    samples: List[float] = []
    try:
        obj = h.make_claim(list(h.gpu_indices))
        err = h.attempt_prepare(obj)
        if err is not None:
            raise RuntimeError(f"baseline prepare failed: {err}")
        for _ in range(n):
            t0 = time.perf_counter()
            h.crash_restart()
            err = h.attempt_prepare(obj)
            if err is not None:
                raise RuntimeError(f"post-crash prepare failed: {err}")
            samples.append((time.perf_counter() - t0) * 1e3)
    finally:
        h.close()
    samples.sort()
    return {
        "chaos_recovery_p50_ms": round(statistics.median(samples), 3),
        "chaos_recovery_p95_ms": round(
            samples[int(0.95 * (len(samples) - 1))], 3),
        "chaos_recovery_crashes": len(samples),
    }


def walk_matrix(seeds: List[int], n_events: int) -> Dict:
    """Every walk over one seed matrix: the plugin walk's summary at the
    top level, the watch-flake scenario at the first seed, and the
    scheduler, topology, node-death and leader-kill walks under their
    own keys (the reference's summary shape)."""
    summary = run_matrix(seeds, n_events=n_events)
    summary["watch_flake_violations"] = run_watch_flake_scenario(
        seed=seeds[0] if seeds else 0)
    # Scheduler-churn walk over the same seed matrix: the event-driven
    # control plane (informers + incremental allocation index + guarded
    # resync + the worker pool) under the sched.* fault sites.
    summary["scheduler"] = run_sched_matrix(seeds, n_events=n_events)
    # Topology walk: contiguity + free-set invariants with the
    # TopologyAwareScheduling gate on.
    summary["topology"] = run_topo_matrix(seeds, n_events=n_events)
    # Node-death walk: node loss and GPU quarantine racing pod churn —
    # eviction must converge (Allocated-on-live-GPUs or
    # Pending-with-reason, no claim pinned to dead hardware, no double
    # allocation).
    summary["node_death"] = run_nodedeath_matrix(seeds, n_events=n_events)
    # HA leader-kill walk: leader kills racing pod churn and eviction,
    # standby takeover via lease expiry + fenced resync — never two
    # acting leaders' commits both landing, no double allocation, no
    # claim leaked across takeover.
    summary["leader_kill"] = run_leaderkill_matrix(seeds,
                                                   n_events=n_events)
    return summary


WALKS = ("scheduler", "topology", "node_death", "leader_kill")

# Each walk's re-arm sites, by its summary key ("plugin" is the
# top-level plugin walk).
REARM_SITES = {
    "plugin": CHAOS_SITES,
    "scheduler": SchedulerChaosHarness.REARM_SITES,
    "topology": TopologyChaosHarness.REARM_SITES,
    "node_death": NodeDeathChaosHarness.REARM_SITES,
    "leader_kill": LeaderKillChaosHarness.REARM_SITES,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="seeded chaos schedule matrix over every walk")
    ap.add_argument("--seeds", type=int, default=25,
                    help="number of schedules")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--events", type=int, default=40,
                    help="lifecycle events per schedule")
    args = ap.parse_args(argv)

    seeds = list(range(args.seed_start, args.seed_start + args.seeds))
    summary = walk_matrix(seeds, args.events)
    failed = bool(summary["violations"]
                  or summary["watch_flake_violations"]
                  or any(summary[w]["violations"] for w in WALKS))
    if failed:
        # Any matrix violation ships its evidence: the flight recorder
        # holds the recent spans, fault firings and queue events around
        # whatever went wrong (TPU_DRA_FLIGHTREC_DUMP pins the path).
        summary["flight_recorder_dump"] = trace.dump_flight_recorder(
            "chaos-violation",
            path=os.environ.get("TPU_DRA_FLIGHTREC_DUMP"))
    print(json.dumps(summary, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
