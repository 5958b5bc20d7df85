"""drmc crash-point enumerator: every durable op, every tear, recovered.

The durability layer routes its writes through ``tpu_dra_torch.infra.vfs``
(checkpoint slot pwrites/truncates/fdatasyncs, CDI spec tmp+rename
writes, the node flock). :class:`RecordingVfs` swaps in behind that
seam, performs every real operation unchanged, and shadows per-file
state the way a disk sees it:

- ``current``  — the content all writes so far produced (page cache);
- ``synced``   — the content as of the file's last fdatasync/fsync
  (what a crash is GUARANTEED to preserve);
- ``dirent_synced`` — whether the file's directory entry is durable
  (pre-existing files; new files once ``fsync_dir`` — or a data sync,
  journaled-fs behavior — covers them).

The enumerator records one fault-free run of a scenario to number its
durable ops, then replays the scenario once per (op, variant),
simulating SIGKILL immediately after that op by raising
:class:`CrashPoint` — a BaseException, so no ``except Exception``
recovery path in the stack under test can swallow the "process death"
— and rewriting the real files to the crash image before recovery:

- ``clean``     — only synced state survived (the guaranteed floor);
- ``persisted`` — everything written so far survived (the lucky
  ceiling; recovery must accept it too, e.g. an orphaned CDI spec);
- ``torn``      — clean, plus a prefix of the crashing write scribbled
  in place (the ``checkpoint.corrupt`` fault-site semantics: a valid
  JSON prefix, broken envelope).

The scenario then restarts its component over the image and asserts
the recovery invariants (replay idempotent, externalized successes
committed, losers rolled back — scenarios.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.infra import vfs
from tpu_dra_torch.analysis.drmc.explore import note_crash_points

# How much of the crashing write the torn variant lands on disk —
# mirrors chaos's _corrupt_one_slot, which scribbles b'{"torn":'.
TORN_PREFIX_BYTES = 8

_WRITE_KINDS = ("pwrite", "write_text")


class CrashPoint(BaseException):
    """Simulated SIGKILL right after durable op `op_index`."""

    def __init__(self, op_index: int, desc: str):
        super().__init__(f"crash after durable op #{op_index} ({desc})")
        self.op_index = op_index
        self.desc = desc


@dataclass
class _FileShadow:
    synced: Optional[bytes]        # None: absent from the synced image
    current: Optional[bytes]       # None: unlinked
    dirent_synced: bool


@dataclass
class DurableOp:
    index: int
    kind: str
    path: str
    offset: int = 0
    data: bytes = b""

    def describe(self) -> str:
        return f"{self.kind} {os.path.basename(self.path)}"


class RecordingVfs(vfs.VfsImpl):
    """See module doc. ``arm()`` starts numbering ops (scenario body
    only — component setup establishes shadows but is not crashed);
    after a crash fires the recorder goes inert passthrough, modeling a
    dead process whose remaining unwind cannot touch the disk state the
    crash froze."""

    def __init__(self, crash_at: Optional[int] = None,
                 variant: str = "clean"):
        self._files: Dict[str, _FileShadow] = {}
        self._fd_paths: Dict[int, str] = {}
        self.ops: List[DurableOp] = []
        self._armed = False
        self._crashed = False
        self._crash_at = crash_at
        self.variant = variant

    # -- shadow bookkeeping --------------------------------------------------

    def _shadow(self, path: str) -> _FileShadow:
        path = os.path.abspath(path)
        sh = self._files.get(path)
        if sh is None:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    content = f.read()
                sh = _FileShadow(synced=content, current=content,
                                 dirent_synced=True)
            else:
                sh = _FileShadow(synced=None, current=None,
                                 dirent_synced=False)
            self._files[path] = sh
        return sh

    def _op(self, kind: str, path: str, offset: int = 0,
            data: bytes = b"") -> None:
        if not self._armed or self._crashed:
            return
        op = DurableOp(index=len(self.ops), kind=kind,
                       path=os.path.abspath(path), offset=offset, data=data)
        self.ops.append(op)
        if self._crash_at is not None and op.index == self._crash_at:
            self._crashed = True
            raise CrashPoint(op.index, op.describe())

    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    @property
    def crashed(self) -> bool:
        return self._crashed

    # -- VfsImpl surface -----------------------------------------------------

    def open_fd(self, path: str, flags: int, mode: int = 0o600) -> int:
        sh = self._shadow(path)       # snapshot pre-existing content
        fd = os.open(path, flags, mode)
        self._fd_paths[fd] = os.path.abspath(path)
        if sh.current is None and (flags & os.O_CREAT):
            sh.current = b""          # created now; dirent still volatile
        return fd

    def close_fd(self, fd: int) -> None:
        self._fd_paths.pop(fd, None)
        os.close(fd)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        # Shadow BEFORE the syscall: a first-touch snapshot after the
        # write would read the write's own bytes as "pre-existing".
        path = self._fd_paths.get(fd)
        sh = self._shadow(path) if path is not None else None
        n = os.pwrite(fd, data, offset)
        if sh is not None and not self._crashed:
            cur = bytearray(sh.current or b"")
            if len(cur) < offset:
                cur.extend(b"\x00" * (offset - len(cur)))
            cur[offset:offset + n] = data[:n]
            sh.current = bytes(cur)
            self._op("pwrite", path, offset, bytes(data[:n]))
        return n

    def ftruncate(self, fd: int, length: int) -> None:
        path = self._fd_paths.get(fd)
        sh = self._shadow(path) if path is not None else None
        os.ftruncate(fd, length)
        if sh is not None and not self._crashed:
            cur = sh.current or b""
            sh.current = (cur[:length] if len(cur) >= length
                          else cur + b"\x00" * (length - len(cur)))
            self._op("ftruncate", path)

    def _sync_fd(self, fd: int, kind: str) -> None:
        path = self._fd_paths.get(fd)
        if path is not None and not self._crashed:
            sh = self._shadow(path)
            sh.synced = sh.current
            # Journaled-fs simplification: a data sync also commits the
            # dirent of a just-created file (ordered-mode behavior).
            sh.dirent_synced = True
            self._op(kind, path)

    def fdatasync(self, fd: int) -> None:
        getattr(os, "fdatasync", os.fsync)(fd)
        self._sync_fd(fd, "fdatasync")

    def fsync(self, fd: int) -> None:
        os.fsync(fd)
        self._sync_fd(fd, "fsync")

    def fsync_dir(self, path: str) -> None:
        super().fsync_dir(path)
        if self._crashed:
            return
        dirpath = os.path.abspath(path or ".")
        for p, sh in self._files.items():
            if os.path.dirname(p) == dirpath:
                sh.dirent_synced = True
        self._op("fsync_dir", dirpath)

    # The next three snapshot the shadow BEFORE the real operation: the
    # shadow's initial read must capture the file's pre-op durability
    # state, not the state the op just produced.

    def write_text(self, path: str, text: str) -> None:
        sh = self._shadow(path)
        with open(path, "w") as f:
            f.write(text)
        if not self._crashed:
            sh.current = text.encode()
            self._op("write_text", path, 0, text.encode())

    def replace(self, src: str, dst: str) -> None:
        ssh, dsh = self._shadow(src), self._shadow(dst)
        os.replace(src, dst)
        if self._crashed:
            return
        dsh.current = ssh.current
        ssh.current = None
        # The rename itself is volatile metadata: until something syncs
        # the directory, the clean image keeps dst's old synced content
        # and src simply never persisted (its dirent was never synced).
        self._op("replace", dst)

    def unlink(self, path: str) -> None:
        sh = self._shadow(path)
        os.unlink(path)
        if not self._crashed:
            sh.current = None
            # An unsynced unlink may be lost: synced content survives in
            # the clean image — recovery must tolerate the file's return.
            self._op("unlink", path)

    def flock(self, fd: int, op: int) -> None:
        super().flock(fd, op)
        path = self._fd_paths.get(fd)
        if path is not None:
            # A crash point, not a write: flock dies with its holder, so
            # "crash right after acquiring the node lock" must recover
            # by simply re-acquiring.
            self._op("flock", path)

    # -- crash image ---------------------------------------------------------

    def _image_content(self, sh: _FileShadow) -> Optional[bytes]:
        if self.variant == "persisted":
            return sh.current
        if sh.synced is not None:
            return sh.synced
        if sh.dirent_synced:
            return b""                # dirent durable, data never synced
        return None

    def materialize_crash_image(self) -> None:
        """Rewrite the real files to what the disk would show after the
        simulated SIGKILL. Call after the crashed stack released its
        fds; recovery then runs against these files."""
        torn_op = (self.ops[-1] if self.variant == "torn" and self.ops
                   else None)
        for path, sh in self._files.items():
            content = self._image_content(sh)
            if (torn_op is not None and path == torn_op.path
                    and torn_op.kind in _WRITE_KINDS):
                base = bytearray(content if content is not None else b"")
                if content is None and not sh.dirent_synced:
                    # The write implies the file existed in cache, but
                    # its dirent never persisted: the whole file is gone
                    # and the tear is unobservable — same as clean.
                    base = None
                if base is not None:
                    prefix = torn_op.data[:TORN_PREFIX_BYTES]
                    off = torn_op.offset
                    if len(base) < off:
                        base.extend(b"\x00" * (off - len(base)))
                    base[off:off + len(prefix)] = prefix
                    content = bytes(base)
            if content is None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            else:
                with open(path, "wb") as f:
                    f.write(content)


# ---------------------------------------------------------------------------
# Enumeration driver
# ---------------------------------------------------------------------------

@dataclass
class CrashOutcome:
    op_index: int
    variant: str
    op: str
    violations: List[str]


@dataclass
class CrashReport:
    scenario: str
    ops: List[str] = field(default_factory=list)
    points_enumerated: int = 0
    points_run: int = 0
    outcomes: List[CrashOutcome] = field(default_factory=list)

    @property
    def violations(self) -> List[str]:
        return [f"crash@{o.op_index}/{o.variant} ({o.op}): {v}"
                for o in self.outcomes for v in o.violations]

    @property
    def ok(self) -> bool:
        return not self.violations and self.points_run

    @property
    def coverage(self) -> float:
        return (self.points_run / self.points_enumerated
                if self.points_enumerated else 0.0)

    def to_dict(self) -> Dict:
        return {"scenario": self.scenario, "ops": self.ops,
                "points_enumerated": self.points_enumerated,
                "points_run": self.points_run,
                "coverage": round(self.coverage, 3),
                "violations": self.violations}


def enumerate_crashes(scenario, fail_fast: bool = False) -> CrashReport:
    """Record the scenario's durable-op sequence fault-free, then crash
    after every op in every applicable variant and run the scenario's
    recovery invariants. 100% of enumerated points run unless
    `fail_fast` stops at the first violation."""
    report = CrashReport(scenario=scenario.name)

    # 1. The recording pass: same code path, no crash, numbering ops.
    rec = RecordingVfs()
    vfs.install(rec)
    ctx = None
    try:
        ctx = scenario.setup()
        rec.arm()
        scenario.body(ctx)
        rec.disarm()
    finally:
        if ctx is not None:
            scenario.dispose(ctx)
        vfs.uninstall()
    baseline = scenario.recover_and_check(ctx)
    if baseline:
        # A fault-free run must be clean or every crash result is noise.
        report.outcomes.append(CrashOutcome(
            op_index=-1, variant="baseline", op="(no crash)",
            violations=baseline))
        return report
    report.ops = [op.describe() for op in rec.ops]

    # 2. One run per (op, variant).
    points: List[Tuple[int, str]] = []
    for op in rec.ops:
        points.append((op.index, "clean"))
        points.append((op.index, "persisted"))
        if op.kind in _WRITE_KINDS:
            points.append((op.index, "torn"))
    report.points_enumerated = len(points)

    for op_index, variant in points:
        crec = RecordingVfs(crash_at=op_index, variant=variant)
        vfs.install(crec)
        ctx = None
        crashed = False
        try:
            ctx = scenario.setup()
            crec.arm()
            try:
                scenario.body(ctx)
            except CrashPoint:
                crashed = True
        finally:
            crec.disarm()
            if ctx is not None:
                scenario.dispose(ctx)   # fd release = the process dying
            vfs.uninstall()
        violations: List[str] = []
        if not crashed:
            violations.append(
                "crash point never fired — the durable-op sequence "
                "diverged from the recording pass")
            # recover_and_check (the usual cleanup owner) never runs on
            # this branch: drop the scenario's scratch state here or
            # every divergent point leaks a tempdir per run. Scenarios
            # may implement discard(ctx); the fallback covers the
            # convention of a "tmp" scratch-dir key.
            discard = getattr(scenario, "discard", None)
            if discard is not None:
                discard(ctx)
            elif isinstance(ctx, dict) and ctx.get("tmp"):
                import shutil
                shutil.rmtree(ctx["tmp"], ignore_errors=True)
        else:
            crec.materialize_crash_image()
            violations = scenario.recover_and_check(ctx)
        report.points_run += 1
        op_desc = (report.ops[op_index]
                   if op_index < len(report.ops) else "?")
        outcome = CrashOutcome(op_index=op_index, variant=variant,
                               op=op_desc, violations=violations)
        report.outcomes.append(outcome)
        if violations and fail_fast:
            break
    note_crash_points(report.points_run, scenario.name)
    return report
