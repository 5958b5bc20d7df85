"""Fault-injection substrate: named sites, armed with schedules.

The reference driver's operational value is surviving partial failure
(NVML event storms, kubelet restarts, API-server flakes), but none of
that is drivable deterministically from tests. This registry gives
production code cheap guard calls at the places failure actually enters
the system — a *site* — and gives chaos tests a way to arm each site
with a *schedule* (every-Nth, probabilistic, one-shot) deciding which
guard invocations fire.

Guard styles, by what the site needs on failure:

- ``check(site, **ctx)``  — raise ``FaultInjected`` (or run the armed
  action with ``ctx``) when the schedule fires; no-op otherwise. For
  sites whose failure mode is an exception (API request, CDI write,
  checkpoint store).
- ``fires(site)``         — plain bool, for sites that model failure as
  control flow (dropping a watch stream) rather than an exception.
- ``pull(site)``          — return the armed payload when the schedule
  fires, else None. For sites that *inject data* (a synthetic chip
  health event) rather than an error.

The disarmed fast path is a single dict emptiness test — cheap enough
to leave on hot paths permanently. All state transitions take a lock;
guards may be hit from many threads (watch loops, workqueues, gRPC
handlers).
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class FaultInjected(Exception):
    """Raised by a fired ``check`` guard with no custom action armed."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


# ---------------------------------------------------------------------------
# Schedules: when does an armed site fire?
# ---------------------------------------------------------------------------

class Schedule:
    """Decides, per guard invocation, whether the armed fault fires.
    ``__call__`` runs under the registry lock — keep it cheap."""

    def __call__(self) -> bool:
        raise NotImplementedError


class EveryNth(Schedule):
    """Fire on every Nth invocation (the deterministic flake)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("n must be >= 1")
        self._n = n
        self._count = 0

    def __call__(self) -> bool:
        self._count += 1
        return self._count % self._n == 0


class Probabilistic(Schedule):
    """Fire with probability p per invocation; seeded rng for replay."""

    def __init__(self, p: float, rng: Optional[random.Random] = None):
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        self._p = p
        self._rng = rng or random.Random()

    def __call__(self) -> bool:
        return self._rng.random() < self._p


class OneShot(Schedule):
    """Fire exactly once, optionally skipping the first `after` calls."""

    def __init__(self, after: int = 0):
        self._skip = after
        self._fired = False

    def __call__(self) -> bool:
        if self._fired:
            return False
        if self._skip > 0:
            self._skip -= 1
            return False
        self._fired = True
        return True


class Always(Schedule):
    """Fire on every invocation (hard outage until disarmed)."""

    def __call__(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Site catalog
# ---------------------------------------------------------------------------

# Every injection site production code consults, with the invariant its
# failure threatens (mirrored in SURVEY.md "Failure model & fault sites").
SITES: Dict[str, str] = {
    "k8s.api.request":
        "API request fails transiently (429/500/503, socket error); "
        "threatens: reconcile convergence, ResourceSlice freshness",
    "k8s.watch.drop":
        "watch stream dies mid-flight; threatens: informer cache "
        "staleness if resume loses events",
    "cdi.claim_write":
        "per-claim CDI spec write fails; threatens: orphaned spec files, "
        "claims stuck half-prepared",
    "prepare.batch_fetch":
        "per-claim ResourceClaim fetch in the batch fan-out fails; "
        "threatens: per-claim error isolation (one 404/flake must not "
        "fail the rest of the NodePrepareResources batch)",
    "prepare.batch_apply":
        "per-claim side-effect application in the batch path fails "
        "mid-batch; threatens: group-commit atomicity (survivors must "
        "commit durably, the loser must roll back cleanly)",
    "checkpoint.store":
        "checkpoint store fails; threatens: claim state-machine "
        "durability, prepare idempotency",
    "prepare.rpc_admit":
        "pipelined RPC admission refuses the RPC before a window slot "
        "or ordering gate is registered (the async front-end's "
        "admission seam, SURVEY §21); threatens: per-claim error "
        "surfacing — the RPC must fail with retryable per-claim errors "
        "and leak neither a window slot nor a claim-uid gate a "
        "successor would wait on forever",
    "prepare.journal_append":
        "append-only checkpoint journal append fails (ENOSPC on the "
        "journal while the slot scheme may still work); threatens: "
        "terminal group-commit durability — the caller must unwind "
        "exactly like a failed terminal store",
    "prepare.journal_compact":
        "bounded-lag journal compaction fails (slot store ENOSPC, "
        "swap rename EIO); threatens: recovery replay length and "
        "journal growth — appends must keep landing and lag must "
        "recover once the fault clears",
    "checkpoint.corrupt":
        "slot file torn/corrupted after a store (action scribbles on the "
        "written paths); threatens: recovery after crash",
    "sched.watch_event":
        "scheduler-side watch event mishandled before the allocation "
        "index/pending set applies it (the handler drops it and marks "
        "the index dirty); threatens: allocated-device index staleness "
        "— the guarded full-resync fallback must converge",
    "sched.index_apply":
        "incremental allocated-device index apply/remove fails; "
        "threatens: index vs cluster-truth divergence, device "
        "double-allocation if an allocation proceeded on a dirty index",
    "sched.shard_apply":
        "per-shard allocation-index mutation fails after routing (the "
        "shard is left unchanged and marked dirty); threatens: per-shard "
        "index==truth divergence — the shard-scoped resync must recover "
        "without blocking scans on sibling shards",
    "sched.snapshot_commit":
        "optimistic snapshot commit refused (models the shard moving "
        "underneath a lock-free candidate scan); threatens: device "
        "double-allocation if a worker committed a stale pick anyway — "
        "the conflict must surface as a bounded re-scan/requeue, never "
        "a partial reservation",
    "cddaemon.spawn":
        "slice-daemon child fails to spawn; threatens: readiness "
        "mirroring, CD convergence",
    "mesh.build":
        "allocation -> mesh plan construction fails (torn topology env, "
        "stale coordinate export, refused rank mapping); threatens: the "
        "data-plane handoff — a workload must see a loud refusal and "
        "retry against fresh claim state, never a silently mis-ordered "
        "mesh whose collectives ride long ICI paths",
    "workload.launch":
        "workload launch on a built mesh fails (admission refusal, "
        "compile/dispatch error at the data-plane seam); threatens: "
        "per-workload bench attribution — one failing launch must "
        "isolate to its own workload record, not blank sibling "
        "workloads or unwind the mesh",
    "health.chip_event":
        "synthetic chip health event (payload-injecting site); "
        "threatens: ResourceSlice vs healthy-chip consistency",
    "health.flap":
        "quarantine-ladder graduation fails to persist (journal append "
        "ENOSPC while a flapping chip crosses the threshold); threatens: "
        "quarantine durability — the chip must stay transient-unhealthy "
        "and re-graduate on the next flap, never half-quarantine or "
        "crash the health callback",
    "sched.evict":
        "eviction of a claim whose allocated chips died fails mid-flight "
        "(deallocation write refused, pod unbind conflict); threatens: "
        "failure-domain convergence — the evict scan must retry with "
        "backoff until every claim ends Allocated-on-live-chips or "
        "Pending-with-reason, never a claim pinned to a dead chip",
    "cd.member_loss":
        "ComputeDomain member-loss handling fails (Degraded status write "
        "conflict, daemon peer-config rewrite error); threatens: a CD "
        "stuck Ready with a dead member, or a daemon crash-looping on "
        "dead peers instead of backing off",
    "trace.emit":
        "span emission into the flight recorder fails (a real "
        "exporter's queue-full/serialization error); threatens: the "
        "span pipeline's degradation contract — the span must drop "
        "counted (trace marked incomplete), the traced operation must "
        "never see the failure, and quiesce invariants must still hold",
    "sched.lease_renew":
        "the leader's lease-renew write fails (apiserver blip, CAS "
        "conflict against a racing takeover); threatens: split brain — "
        "a leader that cannot renew past the lease duration must step "
        "down, and its late claim-status commits must be refused by "
        "the fencing generation, never land next to the new leader's",
    "sched.takeover_resync":
        "the standby's takeover index rebuild fails mid-promotion "
        "(listing refused, shard resync raced); threatens: the new "
        "leader allocating against a stale AllocationIndex — the "
        "takeover must re-drive the guarded resync before commits, "
        "never double-allocate a device the old leader placed",
    "prepare.drain":
        "the hot-restart drain window fails (in-flight RPC wedged past "
        "the bound, drain wait interrupted); threatens: the "
        "zero-failed-RPC restart contract — shutdown must dump "
        "flight-recorder evidence and proceed, leaving clients to mask "
        "the gap by reconnect-retry against the restarted plugin",
    "prepare.reconnect":
        "a client's reconnect dial fails while masking the plugin "
        "restart's socket gap (socket not yet re-listening, transient "
        "ECONNREFUSED); threatens: RPC loss across the restart — the "
        "masking retry must back off and redial within its bound, "
        "never surface the gap to the caller as a failed RPC",
    "sched.watch_shard_dispatch":
        "a partitioned informer's shard delta FIFO refuses an offered "
        "handler dispatch (models the bounded queue at capacity under "
        "fan-out burst); threatens: allocation-index staleness for that "
        "shard — the shed delta must surface through the overflow hook "
        "so the shard is marked dirty and resynced, never silently "
        "skipped while try_commit keeps allocating against it",
    "sched.informer_shard_relist":
        "the scheduler's shard-overflow recovery fails before the "
        "shard-scoped dirty+resync lands (index lock contention, resync "
        "enqueue refused); threatens: a shard that lost deltas staying "
        "clean-looking — the degradation must fall back to marking the "
        "whole index dirty so the guarded full resync converges it",
}

# Declared degradations (drflow R15, SURVEY §20): sites whose injected
# failure has ONE sanctioned degrade path. A broad except handler
# whose try body guards one of these sites must route to the named
# helper (call-chain tail contains the name) or re-raise — an injected
# fault that only gets logged leaves the degrade path chaos thinks is
# covered untested. Sites absent here only owe the generic non-swallow
# discipline.
DEGRADATIONS: Dict[str, str] = {
    # A failed shard apply MUST dirty the shard so the guarded
    # full-resync fallback converges it (scheduler._checked_shard).
    # (cd.member_loss deliberately has NO entry: the controller
    # degrades the domain but the daemon's sanctioned reaction is a
    # re-offered retry — two valid paths, no single declared one.)
    "sched.shard_apply": "mark_dirty",
    # A renew that keeps failing past the lease duration has ONE legal
    # exit: step down (fencing refuses the late writes either way —
    # stepping down just stops throwing work at a lost lease).
    "sched.lease_renew": "step_down",
    # A faulted takeover rebuild re-drives the guarded resync through
    # the queue (scheduler.request_resync) rather than promoting onto
    # a dirty index.
    "sched.takeover_resync": "request_resync",
    # A drain that cannot complete dumps the flight recorder (the
    # wedged in-flight RPC is named by its open span) and shutdown
    # proceeds; clients mask the gap by reconnect-retry.
    "prepare.drain": "dump_flight_recorder",
    # A failed reconnect dial stays on the bounded backoff-redial path
    # (RetryingFramedClient._reconnect_backoff) — masking, not failing.
    "prepare.reconnect": "backoff",
    # A refused shard dispatch has ONE sanctioned exit: shed the delta
    # and report the shard through the overflow hook
    # (ShardDispatcher._shard_overflow) so the consumer resyncs it.
    "sched.watch_shard_dispatch": "shard_overflow",
    # When even the shard-scoped recovery faults, fall back to dirtying
    # the whole index (scheduler._mark_dirty) — over-resync is safe,
    # a clean-looking shard that lost deltas is not.
    "sched.informer_shard_relist": "mark_dirty",
}


# Observer called (outside the registry lock) with the site name every
# time an armed site fires — the flight recorder (infra/trace.py)
# installs itself here so fault firings land in the evidence ring next
# to the spans they perturbed. A hook rather than an import keeps this
# module dependency-free.
_fire_observer: Optional[Callable[[str], None]] = None


def set_fire_observer(observer: Optional[Callable[[str], None]]) -> None:
    global _fire_observer
    _fire_observer = observer


@dataclass
class _Armed:
    schedule: Schedule
    action: Optional[Callable[..., Any]] = None
    payload: Any = None
    fired: int = 0
    calls: int = 0
    detail: str = ""


class FaultRegistry:
    """Registry of injection sites; one global instance (``FAULTS``) is
    consulted by production guards, tests arm/disarm on it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, _Armed] = {}
        self._sites = dict(SITES)

    # -- site catalog -------------------------------------------------------

    def register_site(self, site: str, description: str) -> None:
        """Extension point for out-of-tree sites (tests, plugins)."""
        with self._lock:
            self._sites.setdefault(site, description)

    def sites(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._sites)

    # -- arming -------------------------------------------------------------

    def arm(self, site: str, schedule: Schedule, *,
            action: Optional[Callable[..., Any]] = None,
            payload: Any = None, detail: str = "") -> None:
        """Arm `site` with `schedule`. When a ``check`` guard fires:
        `action(**ctx)` runs if given (it decides whether/what to raise),
        else ``FaultInjected`` is raised. `payload` is what ``pull``
        returns on fire. Unknown site names are rejected — a typo here
        would silently chaos-test nothing."""
        with self._lock:
            if site not in self._sites:
                raise KeyError(f"unknown fault site {site!r} "
                               f"(known: {sorted(self._sites)})")
            self._armed[site] = _Armed(schedule=schedule, action=action,
                                       payload=payload, detail=detail)

    def disarm(self, site: str) -> None:
        with self._lock:
            self._armed.pop(site, None)

    def reset(self) -> None:
        """Disarm everything (chaos quiesce / test teardown)."""
        with self._lock:
            self._armed.clear()

    @contextmanager
    def armed(self, site: str, schedule: Schedule, *,
              action: Optional[Callable[..., Any]] = None,
              payload: Any = None, detail: str = ""):
        """Scoped arm for tests: disarms on exit no matter what."""
        self.arm(site, schedule, action=action, payload=payload,
                 detail=detail)
        try:
            yield self
        finally:
            self.disarm(site)

    # -- guards (production call sites) -------------------------------------

    def _fire(self, site: str) -> Optional[_Armed]:
        # Disarmed fast path: a plain dict emptiness/membership test,
        # no lock (dict reads are atomic under the GIL; a racing arm()
        # is observed on the next guard hit, which is all chaos needs).
        if site not in self._armed:  # dralint: ignore[R10] — deliberate lock-free fast path: GIL-atomic membership test, a racing arm() lands on the next guard hit
            return None
        with self._lock:
            armed = self._armed.get(site)
            if armed is None:
                return None
            armed.calls += 1
            if not armed.schedule():
                return None
            armed.fired += 1
        # Observer outside the lock: the flight recorder's ring append
        # is cheap, but an observer must never extend the registry
        # lock's hold window (guards run on every hot path).
        observer = _fire_observer
        if observer is not None:
            observer(site)
        return armed

    def fires(self, site: str) -> bool:
        """Control-flow guard: True when the armed schedule fires."""
        return self._fire(site) is not None

    def check(self, site: str, **ctx) -> None:
        """Exception guard: raise FaultInjected (or run the armed action
        with `ctx`) when the schedule fires; no-op otherwise."""
        armed = self._fire(site)
        if armed is None:
            return
        if armed.action is not None:
            armed.action(**ctx)
            return
        raise FaultInjected(site, armed.detail)

    def pull(self, site: str) -> Any:
        """Payload guard: the armed payload when the schedule fires
        (a callable payload is invoked to mint the value), else None."""
        armed = self._fire(site)
        if armed is None:
            return None
        payload = armed.payload
        return payload() if callable(payload) else payload

    # -- introspection ------------------------------------------------------

    def fired(self, site: str) -> int:
        with self._lock:
            armed = self._armed.get(site)
            return armed.fired if armed else 0

    def counts(self) -> Dict[str, int]:
        """site -> times fired, for armed sites (chaos reports)."""
        with self._lock:
            return {s: a.fired for s, a in self._armed.items()}

    def take_counts(self) -> Dict[str, int]:
        """counts(), zeroing the fired counters — so a chaos run that
        re-arms sites mid-walk can accumulate without double counting."""
        with self._lock:
            out = {s: a.fired for s, a in self._armed.items()}
            for a in self._armed.values():
                a.fired = 0
            return out


# The process-global registry every production guard consults.
FAULTS = FaultRegistry()
