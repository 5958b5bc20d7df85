"""Durable-op indirection: the seam the crash-point enumerator records.

Every write the project's crash story depends on — checkpoint slot
pwrites/truncates/fdatasyncs (tpuplugin/checkpoint.py), CDI spec
tmp+rename writes (cdi/handler.py), the node-global flock syscall
(infra/flock.py) — goes through this module instead of calling ``os``
directly. By default each function is a thin passthrough (same syscall,
same errors, no extra allocation), so production behavior is untouched.

``install(impl)`` swaps in a recording implementation: drmc's crash
enumerator (tpu_dra/analysis/drmc/crash.py) uses it to shadow per-file
synced-vs-volatile content, number every durable op, and simulate a
SIGKILL after any one of them — including torn variants of the last
write — then restores the on-disk crash image for recovery to chew on.

The indirection is deliberately NOT a class the callers hold: durable
ops are rare (a handful per prepare), module-function dispatch keeps
call sites greppable (``vfs.pwrite`` is the audit trail for "this write
is part of the durability contract"), and a single process-global
implementation matches the single-process crash model being simulated.
"""

from __future__ import annotations

import fcntl
import os
from typing import Optional


class VfsImpl:
    """Override points for a recording implementation. The default
    methods ARE the production behavior; a recorder must preserve the
    real side effects (drmc runs the real stack) while shadowing them."""

    def open_fd(self, path: str, flags: int, mode: int = 0o600) -> int:
        return os.open(path, flags, mode)

    def close_fd(self, fd: int) -> None:
        os.close(fd)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        return os.pwrite(fd, data, offset)

    def preallocate(self, fd: int, offset: int, length: int) -> None:
        """Zero-fill [offset, offset+length) so later appends land in
        already-allocated blocks and their fdatasync stays a pure data
        sync (checkpoint journal segments). Routed through pwrite so a
        recording implementation that only overrides the primitive ops
        still shadows the extension as a durable op."""
        off = 0
        zeros = b"\0" * min(length, 1 << 20)
        while off < length:
            chunk = zeros[:length - off]
            n = self.pwrite(fd, chunk, offset + off)
            if n <= 0:
                raise OSError(f"short preallocation write at {offset + off}")
            off += n

    def ftruncate(self, fd: int, length: int) -> None:
        os.ftruncate(fd, length)

    def fdatasync(self, fd: int) -> None:
        getattr(os, "fdatasync", os.fsync)(fd)

    def fsync(self, fd: int) -> None:
        os.fsync(fd)

    def fsync_dir(self, path: str) -> None:
        dfd = os.open(path or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def write_text(self, path: str, text: str) -> None:
        # os.open/os.write instead of the open() text wrapper: no
        # TextIOWrapper/buffering setup, ~35% cheaper per call — this
        # sits on the claim-spec hot path at batch size (SURVEY §14).
        # Looped: POSIX permits short writes (ENOSPC mid-buffer), and a
        # silently truncated spec renamed into place would hand the
        # container runtime invalid JSON behind a success.
        data = text.encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            off = 0
            while off < len(data):
                n = os.write(fd, data[off:])
                if n <= 0:
                    raise OSError(f"short write to {path} at {off}")
                off += n
        finally:
            os.close(fd)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    def flock(self, fd: int, op: int) -> None:
        fcntl.flock(fd, op)


_DEFAULT = VfsImpl()
_impl: VfsImpl = _DEFAULT


def install(impl: VfsImpl) -> None:
    """Route durable ops through `impl` (drmc crash recording). Not
    refcounted: exactly one recorder at a time, and a second install
    while one is active is a harness bug worth failing loudly on."""
    global _impl
    if _impl is not _DEFAULT:
        raise RuntimeError("vfs recorder already installed")
    _impl = impl


def uninstall() -> None:
    global _impl
    _impl = _DEFAULT


def installed() -> Optional[VfsImpl]:
    return None if _impl is _DEFAULT else _impl


# -- dispatch (the call-site surface) ---------------------------------------

def open_fd(path: str, flags: int, mode: int = 0o600) -> int:
    return _impl.open_fd(path, flags, mode)


def close_fd(fd: int) -> None:
    _impl.close_fd(fd)


def pwrite(fd: int, data: bytes, offset: int) -> int:
    return _impl.pwrite(fd, data, offset)


def preallocate(fd: int, offset: int, length: int) -> None:
    _impl.preallocate(fd, offset, length)


def ftruncate(fd: int, length: int) -> None:
    _impl.ftruncate(fd, length)


def fdatasync(fd: int) -> None:
    _impl.fdatasync(fd)


def fsync(fd: int) -> None:
    _impl.fsync(fd)


def fsync_dir(path: str) -> None:
    _impl.fsync_dir(path)


def write_text(path: str, text: str) -> None:
    _impl.write_text(path, text)


def replace(src: str, dst: str) -> None:
    _impl.replace(src, dst)


def unlink(path: str) -> None:
    _impl.unlink(path)


def flock(fd: int, op: int) -> None:
    _impl.flock(fd, op)
