"""drmc controlled scheduler: deterministic interleaving of real threads.

The substrate both drmc engines share (SURVEY §13). Real project code
runs on real threads, but every thread a scenario spawns is *gated*: it
may only execute between two yield points when the cooperative
scheduler has granted it the next step, and at most ONE controlled
thread runs at any instant. Yield points are the concurrency
primitives' own instrumentation seams — no scenario-side annotations:

- witnessed ``Lock``/``RLock`` acquire/release
  (``infra/lockwitness.set_yield_hook``; drmc installs the witness, so
  every lock tpu_dra_torch code creates during a scenario is both modeled
  here and checked for order cycles there);
- ``infra/workqueue`` enqueue/pop (labeled with the item key — the
  DPOR conflict label) and its condition wait/notify, which drmc
  *virtualizes*: a controlled wait releases the queue lock through the
  instrumented path, parks in the scheduler's model, and re-acquires
  on wakeup, never touching the real ``Condition`` waiter list.

Because the scheduler knows, from the model, which locks are held and
by whom, a granted ``lock.acquire`` can never block for real: a thread
is only schedulable into an acquire when the model says the lock is
free (or self-held, for reentry). Timed condition waits are modeled as
"wakes when notified, or by timeout as a last resort" — a waiting task
becomes schedulable on its own only when nothing else can run, which
keeps bounded scenarios terminating under every schedule while
preserving the spurious-wakeup-tolerant loop contract real timed waits
have.

A run records its full decision trace (chosen task id at every grant).
Feeding the same trace back replays the identical execution — the
replay seam the CLI prints on violation. Deadlocks (every live
task blocked on a held lock) and livelocks (step budget exhausted) are
reported as violations with each task's pending operation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu_dra_torch.infra import lockwitness, workqueue

# States a controlled task moves through.
_STARTING = "starting"  # thread spawned, has not parked yet
_PARKED = "parked"      # at a yield point, waiting for a grant
_RUNNING = "running"    # granted; executing real code
_DONE = "done"
_FAILED = "failed"      # its function raised


class ScheduleError(Exception):
    """Harness-level failure (replay divergence, handshake timeout) —
    distinct from a scenario invariant violation."""


class _Aborted(BaseException):
    """Unwinds a task thread when the scheduler aborts a run; a
    BaseException so scenario code's ``except Exception`` cannot eat
    it (mirrors how a real thread dies with its process)."""


@dataclass(frozen=True)
class Op:
    """One pending operation at a yield point."""
    kind: str                      # lock.acquire|lock.release|queue.add|...
    key: Optional[str]             # lock class (creation site) / queue key
    instance: Optional[int]        # per-run lock/cond identity
    blocking: bool = True

    def conflict_key(self) -> Optional[Tuple[str, str]]:
        """The DPOR-lite conflict label: two pending ops are reorder-
        relevant only when they touch the same lock class or the same
        queue key (the stated reduction rule). Releases carry no
        label — their order against a same-lock acquire is already
        forced by the enabledness model."""
        if self.kind == "lock.acquire":
            return ("lock", self.key or "")
        if self.kind in ("queue.add", "queue.get"):
            return ("queue", self.key or "")
        if self.kind in ("cond.wait", "cond.notify"):
            return ("cond", self.key or "")
        return None

    def describe(self) -> str:
        return f"{self.kind}({self.key})" if self.key else self.kind


@dataclass
class _Task:
    tid: int
    name: str
    fn: Callable[[], None]
    thread: Optional[threading.Thread] = None
    gate: threading.Event = field(default_factory=threading.Event)
    state: str = _STARTING
    pending: Op = field(default_factory=lambda: Op("task.start", None, None))
    notified: bool = False         # cond.wait wakeup posted
    error: Optional[str] = None


@dataclass
class RunResult:
    trace: List[int] = field(default_factory=list)   # chosen tid per grant
    ops: List[str] = field(default_factory=list)     # "tid:op" per grant
    # (step index, untried-alternative tids) — the explorer's backtrack
    # points, computed under the DPOR-lite conflict rule.
    branches: List[Tuple[int, List[int]]] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    steps: int = 0
    complete: bool = False


def scenario_lock():
    """A Lock allocated from tpu_dra_torch code, so the witness's creation-
    site filter instruments it: scenario fixtures living under tests/
    (whose own allocations the witness deliberately ignores) get their
    locks modeled by creating them here. All such locks share one
    creation-site class; the scheduler's model is per-instance, so
    enabledness and deadlock detection are unaffected."""
    return threading.Lock()


class _QueueHooks:
    """The workqueue-facing half of the seam (workqueue.set_drmc_hooks)."""

    def __init__(self, sched: "CooperativeScheduler"):
        self._sched = sched

    def yield_op(self, kind: str, key: str) -> None:
        self._sched.simple_yield(kind, key)

    def wait(self, cond, timeout: float) -> bool:
        return self._sched.controlled_wait(cond)

    def notify(self, cond, all_waiters: bool) -> bool:
        return self._sched.controlled_notify(cond, all_waiters)


class CooperativeScheduler:
    """One controlled run. Usage: ``spawn()`` tasks, then ``run()`` —
    which installs the yield hooks, drives the schedule to completion,
    uninstalls, and returns the :class:`RunResult`."""

    # A controlled thread failing to reach its next yield point within
    # this window means scenario code blocked outside the model (a raw
    # lock, real I/O stall) — abort loudly rather than hang CI.
    HANDSHAKE_TIMEOUT_S = 30.0

    def __init__(self, schedule: Optional[List[int]] = None,
                 max_steps: int = 5000):
        self._schedule = list(schedule or [])
        self._max_steps = max_steps
        self._tasks: List[_Task] = []
        self._by_thread: Dict[int, _Task] = {}
        self._sched_evt = threading.Event()   # a task parked or finished
        self._aborted = False
        # Lock model: instance id -> [owner tid, depth].
        self._owners: Dict[int, List[int]] = {}
        self.result = RunResult()

    # -- scenario surface ----------------------------------------------------

    def spawn(self, name: str, fn: Callable[[], None]) -> int:
        """Register a task. Threads start parked at ``task.start``;
        nothing executes until run() grants it."""
        task = _Task(tid=len(self._tasks), name=name, fn=fn)
        self._tasks.append(task)
        return task.tid

    def run(self) -> RunResult:
        hooks = _QueueHooks(self)
        lockwitness.set_yield_hook(self._lock_hook)
        workqueue.set_drmc_hooks(hooks)
        try:
            for task in self._tasks:
                task.thread = threading.Thread(
                    target=self._task_main, args=(task,),
                    name=f"drmc-{task.name}", daemon=True)
                task.thread.start()
            self._loop()
        finally:
            lockwitness.clear_yield_hook()
            workqueue.clear_drmc_hooks()
            self._release_all()
            for task in self._tasks:
                if task.thread is not None:
                    task.thread.join(timeout=5.0)
                    if task.thread.is_alive():
                        self.result.violations.append(
                            f"harness: task {task.name} did not exit")
        return self.result

    # -- task side -----------------------------------------------------------

    def _task_main(self, task: _Task) -> None:
        self._by_thread[task.thread.ident] = task
        try:
            self._park(task)          # pending == task.start
            task.fn()
            task.state = _DONE
        except _Aborted:
            task.state = _DONE
        except BaseException as e:  # noqa: BLE001 — scenario bug/violation
            task.state = _FAILED
            task.error = f"{type(e).__name__}: {e}"
        finally:
            self._drop_owned(task)
            self._sched_evt.set()

    def _current(self) -> Optional[_Task]:
        return self._by_thread.get(threading.get_ident())

    def _park(self, task: _Task, op: Optional[Op] = None) -> None:
        """Hand control to the scheduler; returns once granted. Order
        matters: the gate is cleared and the pending op published
        BEFORE the parked state becomes visible — the scheduler may
        grant the instant it sees _PARKED, and a clear() after that
        grant would drop it."""
        task.gate.clear()
        if op is not None:
            task.pending = op
        task.state = _PARKED
        self._sched_evt.set()
        task.gate.wait()
        if self._aborted:
            raise _Aborted()

    # -- yield-point entry (lockwitness hook) --------------------------------

    def _lock_hook(self, kind: str, key: str, instance: int,
                   blocking: bool) -> None:
        task = self._current()
        if task is None or task.state == _DONE:
            return  # uncontrolled thread (scenario setup, drains)
        if kind == "lock.acquired":
            own = self._owners.get(instance)
            if own is not None and own[0] == task.tid:
                own[1] += 1           # RLock reentry
            else:
                self._owners[instance] = [task.tid, 1]
            return                    # bookkeeping only, no yield
        self._park(task, Op(kind, key, instance, blocking))
        if kind in ("lock.release", "lock.release_save"):
            own = self._owners.get(instance)
            if own is not None and own[0] == task.tid:
                if kind == "lock.release_save" or own[1] <= 1:
                    del self._owners[instance]
                else:
                    own[1] -= 1

    # -- yield-point entry (workqueue hooks) ---------------------------------

    def simple_yield(self, kind: str, key: Optional[str]) -> None:
        task = self._current()
        if task is None:
            return
        self._park(task, Op(kind, key, None))

    @staticmethod
    def _cond_identity(cond) -> Tuple[str, int]:
        lock = cond._lock
        key = getattr(lock, "_key", None)
        if key is None:
            raise ScheduleError(
                "controlled wait on an unwitnessed condition lock — the "
                "queue must be created while drmc's witness is installed")
        return key, id(lock)

    def controlled_wait(self, cond) -> bool:
        task = self._current()
        if task is None:
            return False              # uncontrolled thread: real wait
        key, inst = self._cond_identity(cond)
        # Release through the instrumented path (its own yield point +
        # model release), park as a waiter, re-acquire when granted.
        cond._lock.release()
        self._park(task, Op("cond.wait", key, inst))
        task.notified = False
        cond._lock.acquire()  # dralint: ignore[R11] — the controlled scheduler IS the instrument: it re-enters a parked waiter's Condition lock by design; the witness models the inner lock itself
        return True

    def controlled_notify(self, cond, all_waiters: bool) -> bool:
        task = self._current()
        if task is None:
            return False
        key, inst = self._cond_identity(cond)
        self._park(task, Op("cond.notify", key, inst))
        waiters = [t for t in self._tasks
                   if t.state == _PARKED and t.pending.kind == "cond.wait"
                   and t.pending.instance == inst and not t.notified]
        for t in (waiters if all_waiters else waiters[:1]):
            t.notified = True
        return True

    # -- scheduler loop ------------------------------------------------------

    def _live(self) -> List[_Task]:
        return [t for t in self._tasks if t.state not in (_DONE, _FAILED)]

    def _enabled(self) -> List[_Task]:
        parked = [t for t in self._tasks if t.state == _PARKED]
        out = []
        for t in parked:
            op = t.pending
            if op.kind == "lock.acquire" and op.blocking:
                own = self._owners.get(op.instance)
                if own is not None and own[0] != t.tid:
                    continue          # held by another task
            if op.kind == "cond.wait" and not t.notified:
                continue              # woken by notify — or timeout, below
            out.append(t)
        if not out:
            # Timeout wakeups as last resort: a timed wait CAN fire, but
            # scheduling it only when nothing else is runnable keeps
            # bounded scenarios from spinning through infinite schedules.
            out = [t for t in parked if t.pending.kind == "cond.wait"]
        return out

    def _wait_all_parked(self) -> None:
        """Block until no controlled task is in flight — the single
        granted task parked again / finished, and every fresh thread
        reached its initial park (a STARTING task is about to park, so
        treating it as runnable would double-grant its first step)."""
        def in_flight():
            return any(t.state in (_RUNNING, _STARTING)
                       for t in self._tasks)
        while in_flight():
            self._sched_evt.clear()
            if in_flight():
                if not self._sched_evt.wait(self.HANDSHAKE_TIMEOUT_S):
                    running = [t.name for t in self._tasks
                               if t.state in (_RUNNING, _STARTING)]
                    raise ScheduleError(
                        f"task(s) {running} never reached a yield point "
                        f"within {self.HANDSHAKE_TIMEOUT_S}s (blocked "
                        "outside the model?)")

    def _loop(self) -> None:
        res = self.result
        try:
            while True:
                self._wait_all_parked()
                if not self._live():
                    res.complete = True
                    break
                enabled = self._enabled()
                if not enabled:
                    res.violations.append(
                        "deadlock: all live tasks blocked — "
                        + "; ".join(
                            f"{t.name} at {t.pending.describe()}"
                            for t in self._live()))
                    break
                if res.steps >= self._max_steps:
                    res.violations.append(
                        f"livelock: schedule exceeded {self._max_steps} "
                        "steps without terminating")
                    break
                chosen = self._choose(enabled)
                self._record(chosen, enabled)
                if chosen.pending.kind == "cond.wait":
                    chosen.notified = True  # grant IS the (timeout) wakeup
                res.steps += 1
                # Flip to RUNNING here, not on the task thread: the next
                # _wait_all_parked must already see the grant in flight.
                chosen.state = _RUNNING
                chosen.gate.set()
        except ScheduleError as e:
            res.violations.append(f"harness: {e}")
        finally:
            failed = [t for t in self._tasks if t.state == _FAILED]
            for t in failed:
                res.violations.append(f"task {t.name} raised: {t.error}")

    def _choose(self, enabled: List[_Task]) -> _Task:
        step = len(self.result.trace)
        if step < len(self._schedule):
            want = self._schedule[step]
            for t in enabled:
                if t.tid == want:
                    return t
            raise ScheduleError(
                f"replay divergence at step {step}: scheduled tid {want} "
                f"not enabled (enabled: {[t.tid for t in enabled]})")
        return min(enabled, key=lambda t: t.tid)

    def _record(self, chosen: _Task, enabled: List[_Task]) -> None:
        res = self.result
        step = len(res.trace)
        res.trace.append(chosen.tid)
        res.ops.append(f"{chosen.name}:{chosen.pending.describe()}")
        if len(enabled) > 1 and step >= len(self._schedule):
            ck = chosen.pending.conflict_key()
            alts = [t.tid for t in enabled if t is not chosen
                    and (t.pending.kind == "task.start"  # next op unknown:
                         #   branch conservatively or start order is fixed
                         or (ck is not None
                             and t.pending.conflict_key() == ck))]
            if alts:
                res.branches.append((step, alts))

    # -- teardown ------------------------------------------------------------

    def _drop_owned(self, task: _Task) -> None:
        for inst in [i for i, own in self._owners.items()
                     if own[0] == task.tid]:
            # A task that exits while owning a modeled lock left the
            # REAL lock held too — the deadlock it causes for siblings
            # is reported by the enabledness model; drop the entry so
            # teardown doesn't wedge.
            del self._owners[inst]

    def _release_all(self) -> None:
        self._aborted = True
        for t in self._tasks:
            t.gate.set()
