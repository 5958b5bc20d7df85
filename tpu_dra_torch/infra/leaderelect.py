"""Active-standby leader election over a coordination.k8s.io Lease
(counterpart of tpu_dra/infra/leaderelect.py).

The sim scheduler becomes a replicated control-plane component by
putting every replica behind an elector. Exactly one replica acts at a
time; the others run warm informers with a paused work queue
(``Scheduler.start(standby=True)``) and take over when the lease
expires.

Three pieces, client-go's leaderelection package shrunk to what the sim
needs:

- **LeaderElector** — a jittered renew loop per replica. The holder
  renews ``spec.renewTime`` by CAS (the fake apiserver's
  resourceVersion conflict is the compare half); a standby watches for
  expiry and CASes itself in, bumping ``spec.leaseTransitions``. Two
  standbys racing a takeover CAS the same resourceVersion and exactly
  one wins: the apiserver settles the double-takeover race.

- **Fencing** — ``leaseTransitions`` is the fencing generation. A
  leader stamps its current generation into every claim-status write
  (``Scheduler._stamp_fence``); ``install_fencing`` adds an
  apiserver-side reactor that refuses any stamped write whose
  generation is behind the lease's. A deposed leader that missed its
  own deposal (a pause, a partition) keeps stamping the OLD generation,
  so its late commits are refused, never landed next to the new
  leader's. The elector never clears the generation on step-down:
  fencing only works if the stale stamp keeps flowing. Fencing is
  scoped to ResourceClaims: the scheduler is their only round-trip
  writer (and always re-stamps with its current generation); pods,
  which the node sim co-writes, are neither stamped nor fenced.

- **Step-down** — a leader whose renew keeps failing past the lease
  duration stops acting (the ``sched.lease_renew`` site's declared
  degradation). Correctness never depends on it (fencing refuses the
  writes regardless); it stops work on a lost lease.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from tpu_dra_torch.infra.faults import FAULTS, FaultInjected
from tpu_dra_torch.infra.metrics import SCHED_LEADER, SCHED_LEASE_TRANSITIONS
from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ApiError, ConflictError, NotFoundError,
    json_deepcopy,
)
from tpu_dra_torch.k8s.fake import (
    lease_micro_time, new_lease, parse_lease_micro_time,
)
from tpu_dra_torch.k8s.resources import LEASES, RESOURCECLAIMS

log = logging.getLogger("tpu_dra_torch.leaderelect")

LEASE_NAME = "sim-scheduler"
LEASE_NAMESPACE = "kube-system"

# Stamped into every acting leader's claim-status writes; compared by
# the install_fencing reactor against the lease's current
# leaseTransitions.
FENCING_ANNOTATION = "sim/sched-lease-generation"


class LeaderElector:
    """One replica's election loop. Callbacks run on the elector
    thread: ``on_started_leading(generation)`` at acquire/takeover,
    ``on_stopped_leading(reason)`` at step-down or observed deposal.
    They must be quick or hand off (the scheduler's promote() rebuilds
    the index inline: a takeover is the failover path). ``clock`` and
    ``seed`` make a tick-driven run deterministic."""

    def __init__(self, client: ApiClient, identity: str, *,
                 name: str = LEASE_NAME,
                 namespace: str = LEASE_NAMESPACE,
                 lease_duration_s: float = 1.0,
                 renew_interval_s: float = 0.25,
                 jitter: float = 0.2,
                 on_started_leading: Optional[Callable[[int], None]] = None,
                 on_stopped_leading: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.time,
                 seed: Optional[int] = None):
        self._client = client
        self.identity = identity
        self._name = name
        self._namespace = namespace
        self._lease_duration_s = lease_duration_s
        self._renew_interval_s = renew_interval_s
        self._jitter = jitter
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._clock = clock
        self._rng = random.Random(seed if seed is not None
                                  else hash(identity) & 0xFFFFFFFF)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.is_leader = False
        # The fencing token of the LAST successful acquire, kept
        # through step-down (see module docstring).
        self.generation: Optional[int] = None
        self._last_renew = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"leaderelect-{self.identity}")
        self._thread.start()

    def stop(self, release: bool = False) -> None:
        """Stop electing. ``release=True`` is a graceful handover: zero
        renewTime so a standby takes over without waiting out the
        duration; the default is the crash/kill shape, in which the
        standby must detect expiry."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        was_leader = self.is_leader
        if self.is_leader:
            self._step_down("stopped")
        if release and was_leader:
            try:
                lease = self._client.get(LEASES, self._name,
                                         self._namespace)
                spec = lease.get("spec") or {}
                if spec.get("holderIdentity") == self.identity:
                    upd = json_deepcopy(lease)
                    upd["spec"]["renewTime"] = lease_micro_time(0.0)
                    self._client.update(LEASES, upd, self._namespace)
            except ApiError:
                pass  # best effort: the lease expires on schedule instead

    def tick(self) -> None:
        """One election step (public for deterministic tests: the run
        loop is exactly this under a jittered timer)."""
        self._tick()

    # -- the loop ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("election tick failed (%s)", self.identity)
            self._stop.wait(self._renew_interval_s
                            * (1.0 + self._jitter * self._rng.random()))

    def _tick(self) -> None:
        now = self._clock()
        try:
            lease = self._client.get(LEASES, self._name, self._namespace)
        except NotFoundError:
            self._create(now)
            return
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            self._renew(lease, now)
            return
        if self.is_leader:
            # Someone else took the lease while we thought we held it
            # (our renew lost the CAS race): deposed. Fencing already
            # refuses our late writes; stop acting too.
            self._step_down(f"deposed by {holder}")
        duration = float(spec.get("leaseDurationSeconds")
                          or self._lease_duration_s)
        renewed = parse_lease_micro_time(spec.get("renewTime"))
        if now - renewed < duration:
            return  # live foreign leader: stay standby
        self._takeover(lease, now)

    def _create(self, now: float) -> None:
        obj = new_lease(self._name, self._namespace, self.identity,
                        self._lease_duration_s, now)
        try:
            created = self._client.create(LEASES, obj, self._namespace)
        except AlreadyExistsError:
            return  # raced another replica's create: it leads
        self._became_leader(created, now)

    def _renew(self, lease, now: float) -> None:
        try:
            # Injection site: the renew write fails (apiserver blip) or
            # the CAS loses to a racing takeover.
            FAULTS.check("sched.lease_renew", identity=self.identity)
            upd = json_deepcopy(lease)
            upd["spec"]["renewTime"] = lease_micro_time(now)
            self._client.update(LEASES, upd, self._namespace)
            self._last_renew = now
            if not self.is_leader:
                # Holder per the lease but not acting (a restarted
                # replica finding its own still-live lease): resume.
                self._became_leader(upd, now)
        except (FaultInjected, ConflictError, NotFoundError) as e:
            # Declared degradation (sched.lease_renew): renews failing
            # past the lease duration step the leader down — its lease
            # is as good as lost and fencing already refuses its
            # commits.
            if self.is_leader and \
                    now - self._last_renew >= self._lease_duration_s:
                self._step_down(f"renew failing past lease duration: {e}")

    def _takeover(self, lease, now: float) -> None:
        upd = json_deepcopy(lease)
        spec = upd.setdefault("spec", {})
        spec["holderIdentity"] = self.identity
        spec["acquireTime"] = spec["renewTime"] = lease_micro_time(now)
        spec["leaseDurationSeconds"] = self._lease_duration_s
        spec["leaseTransitions"] = int(spec.get("leaseTransitions") or 0) + 1
        try:
            updated = self._client.update(LEASES, upd, self._namespace)
        except (ConflictError, NotFoundError):
            return  # lost the takeover CAS: exactly one standby wins
        self._became_leader(updated, now)

    # -- transitions ---------------------------------------------------------

    def _became_leader(self, lease, now: float) -> None:
        generation = int((lease.get("spec") or {})
                         .get("leaseTransitions") or 0)
        with self._lock:
            self.is_leader = True
            self.generation = generation
            self._last_renew = now
        SCHED_LEASE_TRANSITIONS.inc()
        SCHED_LEADER.set(1, labels={"identity": self.identity})
        log.info("%s acquired scheduler lease (generation %d)",
                 self.identity, generation)
        if self._on_started:
            self._on_started(generation)

    def _step_down(self, reason: str) -> None:
        with self._lock:
            if not self.is_leader:
                return
            self.is_leader = False
            # self.generation intentionally KEPT: the stale stamp is
            # what fencing refuses.
        SCHED_LEADER.set(0, labels={"identity": self.identity})
        log.warning("%s stepped down: %s", self.identity, reason)
        if self._on_stopped:
            self._on_stopped(reason)


def install_fencing(cluster, *, name: str = LEASE_NAME,
                    namespace: str = LEASE_NAMESPACE):
    """Apiserver-side fencing (a FakeCluster reactor): refuse any
    ResourceClaim update stamped with a lease generation BEHIND the
    lease's current leaseTransitions — the deposed leader's late
    commit, arriving after a takeover bumped the generation. Writes
    without the stamp pass, and a missing lease passes (no election in
    this cluster). Returns the reactor so tests can remove it."""

    def _fence(verb: str, gvr, obj):
        if verb != "update" or obj is None \
                or gvr.key != RESOURCECLAIMS.key:
            return None
        stamped = ((obj.get("metadata") or {}).get("annotations")
                   or {}).get(FENCING_ANNOTATION)
        if stamped is None:
            return None
        try:
            lease = cluster.get(LEASES, name, namespace)
        except NotFoundError:
            return None
        current = int((lease.get("spec") or {})
                      .get("leaseTransitions") or 0)
        if int(stamped) < current:
            raise ConflictError(
                f"{gvr.plural}/{(obj.get('metadata') or {}).get('name')}: "
                f"fenced write refused (lease generation {stamped} < "
                f"current {current})")
        return None

    cluster.reactors.append(_fence)
    return _fence
