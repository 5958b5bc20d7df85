"""Child-process supervision for the native domain daemon (counterpart
of tpu_dra/cddaemon/process.py).

Start/stop/restart with wait-reaping, a watchdog that restarts the child
on unexpected exit, and signal forwarding. Consecutive crashes back off
exponentially (capped) instead of respawning a crash-looping child every
tick, and an ``on_restart`` hook lets the owner republish readiness the
moment a replacement child is spawned.

Locking: ``self._lock`` is a data lock — it guards the manager's fields
and is never held across blocking work. The fork/exec and child-reap
syscalls run OUTSIDE it, serialized by a *spawn slot* (``_spawning``)
claimed under the lock: whichever of ensure_started / restart / the
watchdog claims the slot performs the blocking spawn alone, and racers
skip (the watchdog retries on its next tick).
"""

from __future__ import annotations

import logging
import signal
import subprocess
import threading
import time
from typing import Callable, List, Optional

from tpu_dra_torch.infra.faults import FAULTS

log = logging.getLogger("tpu_dra_torch.cddaemon.process")


class ProcessManager:
    # Consecutive-crash restart backoff: first respawn is immediate (the
    # common one-off crash), then 0.5s * 2^n capped at 15s — a corrupt
    # config must not fork-bomb the node at watchdog frequency.
    RESTART_BACKOFF_BASE = 0.5
    RESTART_BACKOFF_MAX = 15.0

    def __init__(self, argv: List[str], watchdog_interval: float = 1.0,
                 on_restart: Optional[Callable[[], None]] = None):
        self._argv = argv
        self._interval = watchdog_interval
        self._on_restart = on_restart
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.RLock()
        self._want_running = False
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self.restarts = 0
        self._crashes = 0           # consecutive, reset on confirmed-ready
        self._next_restart_at = 0.0
        # Non-fatal signals are held until the child is confirmed alive
        # (mark_ready(), driven by the wrapper's first successful READY
        # probe): a SIGUSR1 delivered in the exec->handler-install window
        # kills the child with its default disposition ("child exited
        # unexpectedly (rc=-10)").
        self._confirmed_ready = False
        self._pending_signals: List[int] = []
        # Spawn slot: True while one thread runs the blocking fork/exec
        # outside _lock; claimed/released only under _lock. _spawn_done
        # is the slot's completion signal: cleared at claim, set after
        # the spawn committed, aborted-and-reaped, or failed — stop()
        # waits on it so a freshly spawned child can never outlive stop.
        self._spawning = False
        self._spawn_done = threading.Event()
        self._spawn_done.set()
        # Watchdog start slot: same shape as the spawn slot, so two
        # concurrent ensure_started() calls cannot start two watchdogs.
        self._watchdog_starting = False

    # -- lifecycle ----------------------------------------------------------

    def ensure_started(self) -> None:
        with self._lock:
            self._want_running = True
            spawn = ((self._proc is None or self._proc.poll() is not None)
                     and self._claim_spawn_slot_locked())
        if spawn:
            # Raises on exec failure (fault site / OSError): propagate to
            # the caller without starting the watchdog — same contract as
            # the pre-slot code, where the spawn failed inside the lock.
            self._spawn_and_commit()
        with self._lock:
            wd = self._watchdog
        if wd is not None and wd.is_alive() and self._stop.is_set():
            # A previous stop() left an exiting (or spawn-wedged)
            # watchdog behind: give it a moment to finish so the child
            # spawned above does not run unsupervised.
            wd.join(timeout=2)
        start = False
        with self._lock:
            wd = self._watchdog
            if wd is not None and not wd.is_alive():
                wd = self._watchdog = None  # stop() kept a dead handle
            if wd is None and not self._watchdog_starting:
                self._watchdog_starting = True
                start = True
        if wd is not None and self._stop.is_set():
            log.warning("previous watchdog still wedged; supervision "
                        "re-arms on a later ensure_started()")
        if start:
            # Re-arm after a previous stop(): a set _stop would make the new
            # watchdog thread exit immediately, leaving the child unwatched.
            self._stop.clear()
            wd = threading.Thread(
                target=self._watch, daemon=True, name="process-watchdog")
            # Start BEFORE publishing: a concurrent stop() must never
            # join() a thread that was never started (RuntimeError). If
            # it reads None instead, the fresh watchdog sees _stop set
            # and exits on its first wait.
            try:
                wd.start()
            except BaseException:
                with self._lock:
                    self._watchdog_starting = False  # slot must not wedge
                raise
            with self._lock:
                self._watchdog = wd
                self._watchdog_starting = False

    def _claim_spawn_slot_locked(self) -> bool:
        """Claim the single spawn slot (False: another thread is already
        mid-spawn — skip; the watchdog re-checks on its next tick)."""
        if self._spawning:
            return False
        self._spawning = True
        self._spawn_done.clear()
        # The child being replaced can no longer confirm readiness;
        # hold non-fatal signals for the replacement's exec window.
        self._confirmed_ready = False
        return True

    def _spawn_and_commit(self) -> Optional[subprocess.Popen]:
        """Blocking fork/exec, run OUTSIDE _lock with the spawn slot
        held. Commits the child under the lock; returns None when a
        concurrent stop() made the spawn moot (the fresh child is
        terminated, not committed)."""
        try:
            # Injection site: exec failure (binary missing after an image
            # upgrade, ENOMEM) — the supervisor must back off and keep
            # trying, not die with the watchdog thread.
            FAULTS.check("cddaemon.spawn", argv=self._argv)
            log.info("starting: %s", " ".join(self._argv))
            proc = subprocess.Popen(self._argv)
        except BaseException:
            with self._lock:
                self._spawning = False
            self._spawn_done.set()
            raise
        with self._lock:
            self._spawning = False
            abort = not self._want_running
            if not abort:
                self._confirmed_ready = False
                self._proc = proc
        if abort:
            # Reap BEFORE signaling done: a stop() blocked on
            # _spawn_done must find the aborted child already dead.
            self._reap(proc)
            self._spawn_done.set()
            return None
        self._spawn_done.set()
        return proc

    @staticmethod
    def _reap(proc: subprocess.Popen, grace: float = 5.0) -> None:
        """Terminate + wait (escalating to SIGKILL); never under _lock."""
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def stop(self, grace: float = 5.0) -> None:
        with self._lock:
            self._want_running = False
            proc = self._proc
        self._stop.set()
        if proc is not None:
            self._reap(proc, grace)
        # An in-flight spawn either commits (visible below) or aborts —
        # reaping its child — before signaling done; wait so no fresh
        # child outlives stop(). A Popen wedged past `grace` is the one
        # bounded exception, mirroring the reap escalation timeout.
        self._spawn_done.wait(timeout=grace)
        with self._lock:
            committed = self._proc
        if committed is not None and committed is not proc:
            self._reap(committed, grace)  # spawn committed mid-stop
        with self._lock:
            wd = self._watchdog
        if wd is not None:
            wd.join(timeout=2)
            if wd.is_alive():
                # Wedged mid-spawn past every grace: keep the handle so
                # ensure_started() cannot start a duplicate watchdog;
                # the thread exits on its own when the spawn unwedges
                # (_stop is set).
                log.warning("watchdog did not stop within 2s; "
                            "keeping handle to prevent a duplicate")
            else:
                with self._lock:
                    if self._watchdog is wd:
                        self._watchdog = None

    def restart(self) -> None:
        """Full stop/start (legacy IP-mode membership change)."""
        with self._lock:
            proc = self._proc
            spawn = self._want_running and self._claim_spawn_slot_locked()
        if proc is not None:
            self._reap(proc)
        if spawn and self._spawn_and_commit() is not None:
            with self._lock:
                self.restarts += 1

    def signal(self, sig: int = signal.SIGUSR1) -> None:
        """Forward a signal (SIGUSR1 = re-resolve peers).

        Held (coalesced) until mark_ready() if the current child has not
        yet been confirmed ready; a membership-change nudge is idempotent,
        so one deferred delivery is equivalent to many.
        """
        with self._lock:
            if not self._confirmed_ready:
                if sig not in self._pending_signals:
                    self._pending_signals.append(sig)
                return
            if self._proc is not None and self._proc.poll() is None:
                self._proc.send_signal(sig)

    def pid(self) -> Optional[int]:
        """Pid of the current child, or None. Snapshot this *before* a
        readiness probe and pass it to mark_ready() so a probe answered by
        a child that has since been restarted cannot confirm its
        replacement."""
        with self._lock:
            return None if self._proc is None else self._proc.pid

    def mark_ready(self, pid: Optional[int] = None) -> None:
        """The child answered its readiness probe: safe to deliver held
        signals (its handlers are necessarily installed by then).

        ``pid``: the pid() snapshot taken before the probe. If the child
        has been replaced since (watchdog restart), the confirmation is
        stale — ignoring it keeps held signals out of the new child's
        exec window, which is the exact race this hold exists to close.
        """
        with self._lock:
            if self._proc is None:
                return
            if pid is not None and self._proc.pid != pid:
                return
            self._confirmed_ready = True
            # A child that reached ready ends the crash streak: the next
            # unexpected exit restarts immediately again.
            self._crashes = 0
            self._next_restart_at = 0.0
            pending, self._pending_signals = self._pending_signals, []
            for sig in pending:
                if self._proc.poll() is None:
                    self._proc.send_signal(sig)

    def running(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    # -- watchdog -----------------------------------------------------------

    def _watch(self) -> None:
        while not self._stop.wait(self._interval):
            with self._lock:
                if not self._want_running or self._spawning:
                    continue
                if self._proc is None or self._proc.poll() is None:
                    continue
                now = time.monotonic()
                if now < self._next_restart_at:
                    continue  # crash-looping: hold the backoff
                log.warning("child exited unexpectedly (rc=%s); restarting"
                            " (crash streak %d)", self._proc.returncode,
                            self._crashes + 1)
                self._crashes += 1
                self._next_restart_at = now + min(
                    self.RESTART_BACKOFF_BASE * (2 ** (self._crashes - 1)),
                    self.RESTART_BACKOFF_MAX)
                self._claim_spawn_slot_locked()
            try:
                restarted = self._spawn_and_commit() is not None
            except Exception:  # noqa: BLE001 — spawn failed: the backoff
                # above already schedules the next attempt; the watchdog
                # thread must survive to make it.
                log.exception("respawn failed; retrying after backoff")
                continue
            if restarted:
                with self._lock:
                    self.restarts += 1
            if restarted and self._on_restart is not None:
                # On its own thread: the hook touches the API server
                # (readiness republish, with retries that can run long
                # during an outage) and must stall neither supervision —
                # a child dying mid-hook still gets its backed-off
                # respawn — nor stop()'s watchdog join.
                threading.Thread(target=self._run_restart_hook,
                                 daemon=True,
                                 name="process-on-restart").start()

    def _run_restart_hook(self) -> None:
        try:
            self._on_restart()
        except Exception:  # noqa: BLE001 — a broken hook must not kill
            # the supervisor
            log.exception("on_restart hook failed")
