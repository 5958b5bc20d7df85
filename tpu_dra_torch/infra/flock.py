"""Polling non-blocking flock(2) with timeout and cancellation
(counterpart of tpu_dra/infra/flock.py, copied as it is).

Guards prepare/unprepare node-globally: during a rolling driver upgrade
two plugin pods briefly coexist on one node and must never interleave
Prepare/Unprepare. Non-blocking + poll (rather than a blocking flock)
keeps the timeout and cancel semantics portable.
"""

from __future__ import annotations

import errno
import fcntl
import os
import threading
import time
from typing import Optional

from tpu_dra_torch.infra import vfs


class FlockTimeout(TimeoutError):
    pass


class Flock:
    def __init__(self, path: str, poll_interval: float = 0.1):
        # GUARDED_BY: none — immutable after construction
        self._path = path
        self._poll = poll_interval
        self._fd: Optional[int] = None
        self._tlock = threading.Lock()  # in-process serialization

    @property
    def path(self) -> str:
        return self._path

    def acquire(self, timeout: float = 10.0,
                cancel: Optional[threading.Event] = None) -> None:
        """Acquire or raise FlockTimeout. Re-opens the file each attempt so a
        deleted lock file doesn't wedge us holding a stale inode."""
        deadline = time.monotonic() + timeout
        if not self._tlock.acquire(timeout=timeout):
            raise FlockTimeout(f"in-process lock on {self._path} not acquired "
                               f"within {timeout}s")
        try:
            self._lock_file(deadline, timeout, cancel)
        except BaseException:
            self._tlock.release()
            raise

    def _lock_file(self, deadline: float, timeout: float,
                   cancel: Optional[threading.Event] = None) -> None:
        """The flock(2) poll loop alone; the caller serializes this
        instance's callers (``_tlock``, or SharedFlock's own protocol)."""
        while True:
            if cancel is not None and cancel.is_set():
                raise FlockTimeout(f"lock acquisition on {self._path} cancelled")
            fd = vfs.open_fd(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                # Through the vfs seam: the enumerator treats the
                # acquire as a crash point — an flock dies with its
                # holder, so recovery must simply re-acquire.
                vfs.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._fd = fd
                return
            except OSError as e:
                vfs.close_fd(fd)
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
            except BaseException:
                # A simulated crash (drmc CrashPoint) fired inside
                # the flock syscall seam: close the fd — process
                # death would have — or the exclusive lock leaks
                # into the long-lived harness process.
                vfs.close_fd(fd)
                raise
            if time.monotonic() >= deadline:
                raise FlockTimeout(
                    f"flock on {self._path} not acquired within {timeout}s")
            time.sleep(self._poll)

    def release(self) -> None:
        # Nested finally: the unlock op can raise through the vfs seam
        # (drmc crash point on LOCK_UN) — the in-process serializer
        # release must still happen, or the next acquire on this
        # instance wedges on _tlock.
        try:
            self._unlock_file()
        finally:
            self._tlock.release()

    def _unlock_file(self) -> None:
        # Nested finally: the fd close must happen even when the unlock
        # raises through the vfs seam.
        if self._fd is not None:
            try:
                vfs.flock(self._fd, fcntl.LOCK_UN)
            finally:
                vfs.close_fd(self._fd)
                self._fd = None

    def __enter__(self) -> "Flock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SharedFlock:
    """In-process shared ownership over a node-global Flock.

    The flock guards against a SECOND PROCESS (rolling-upgrade driver
    pod) interleaving prepare/unprepare — concurrent RPC threads of ONE
    process are already serialized where it matters (per-claim-set
    pipeline ordering + DeviceState's internal locking), so they may
    share the file lock: the first thread in acquires it, late joiners
    just bump a refcount, and the last thread out releases it. Without
    this, the pipelined server would re-serialize every RPC on the
    flock and the cross-RPC group commit could never coalesce.

    Distinct threads may acquire and release, which is exactly the
    pattern here: a share takes the Flock's file lock alone (see
    acquire), never the Flock's thread-owned in-process lock.

    Fairness: under sustained RPC traffic, late joiners could keep the
    refcount above zero forever and the OS flock would never drop — a
    rolling-upgrade peer process would starve past its acquire timeout.
    So a continuous shared hold is BOUNDED (`max_shared_hold_s`): once
    exceeded, new joiners drain — they wait for the current holders to
    finish and the real flock to be released/reacquired, giving the
    competing process its handoff window (the same window the
    pre-pipeline flock-per-RPC behavior provided between every RPC)."""

    def __init__(self, flock: Flock, max_shared_hold_s: float = 5.0):
        self._flock = flock
        self._max_shared_hold_s = max_shared_hold_s
        # Condition over an explicit Lock created in this frame so the
        # lock witness instruments it (workqueue precedent).
        self._ref_cond = threading.Condition(threading.Lock())
        self._refs = 0
        self._acquiring = False
        self._held_since = 0.0

    @property
    def path(self) -> str:
        return self._flock.path

    def acquire(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        with self._ref_cond:
            while True:
                if self._acquiring:
                    # Someone is mid-acquire on the real flock:
                    # piggyback on their outcome rather than racing a
                    # second syscall.
                    pass
                elif self._refs > 0:
                    if (time.monotonic() - self._held_since
                            < self._max_shared_hold_s):
                        self._refs += 1
                        return
                    # Drain: the shared hold has run long enough; wait
                    # for a full release so another PROCESS gets its
                    # flock handoff window before we re-share.
                else:
                    self._acquiring = True
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._ref_cond.wait(
                        timeout=remaining):
                    raise FlockTimeout(
                        f"shared flock on {self._flock.path} not "
                        f"acquired within {timeout}s")
        try:
            # The blocking flock syscall runs OUTSIDE the condition so
            # joiners park on the condition, not behind a held mutex.
            # The file lock alone: `_acquiring` and the refcount already
            # serialize this instance's callers, and the Flock's own
            # in-process lock would be held by whichever thread got here
            # first and released by whichever leaves last — a mutex
            # owned by no thread, which the lock witness would book as
            # held by its first holder long after it left.
            remaining = max(0.05, deadline - time.monotonic())
            self._flock._lock_file(time.monotonic() + remaining, remaining)
        except BaseException:
            with self._ref_cond:
                self._acquiring = False
                self._ref_cond.notify_all()
            raise
        with self._ref_cond:
            self._acquiring = False
            self._refs = 1
            self._held_since = time.monotonic()
            self._ref_cond.notify_all()

    def release(self) -> None:
        with self._ref_cond:
            self._refs -= 1
            if self._refs > 0:
                return
            try:
                self._flock._unlock_file()
            finally:
                self._ref_cond.notify_all()
