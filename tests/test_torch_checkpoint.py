"""Crash consistency of the port's checkpoint slots
(tpu_dra_torch/gpuplugin/checkpoint.py, counterpart of
tpu_dra/tpuplugin/checkpoint.py).

A terminal store writes a side slot without syncing it and then the
primary with fdatasync. After two terminal stores in a row, neither side
slot need be on the device; if the third store's primary write tears in
a power loss, the settled state of the live claims must still come back.
The recording VFS below keeps, per file, the bytes the last sync made
durable; a crash rewrites every file with those bytes and leaves the
primary torn (the new record's first half over the old one).

Held against the reference's own policy only in what it shares: the
same slot layout and envelopes; the sync of the side slot after a
terminal store is the port's (the reference leaves that gap, ADVICE.md).
"""

import os

import pytest

from tpu_dra_torch.gpuplugin.checkpoint import (
    PREPARE_COMPLETED, Checkpoint, CheckpointError, CheckpointManager,
    PreparedClaim,
)
from tpu_dra_torch.infra import vfs


class PowerLoss(BaseException):
    """The machine stops: no handler of the code under test runs (a
    compaction's degraded-mode ``except Exception`` must not catch it)."""


class CrashVfs(vfs.VfsImpl):
    """Shadows the durable bytes of every file the checkpoint opens.
    With `tear` set to a path, the next pwrite there lands half its
    record and raises PowerLoss."""

    def __init__(self):
        self.path_of = {}
        self.durable = {}
        self.tear = None

    @staticmethod
    def _read(path):
        with open(path, "rb") as f:
            return f.read()

    def open_fd(self, path, flags, mode=0o600):
        existed = os.path.exists(path)
        fd = super().open_fd(path, flags, mode)
        self.path_of[fd] = path
        if path not in self.durable:
            self.durable[path] = self._read(path) if existed else b""
        return fd

    def pwrite(self, fd, data, offset):
        path = self.path_of[fd]
        if path == self.tear:
            # Half of the record itself, not of its padding.
            half = bytes(data[:len(bytes(data).rstrip(b" ")) // 2])
            super().pwrite(fd, half, offset)
            # The torn prefix reached the device, the rest did not.
            old = self.durable[path]
            torn = bytearray(old.ljust(offset + len(half), b"\0"))
            torn[offset:offset + len(half)] = half
            self.durable[path] = bytes(torn)
            raise PowerLoss(path)
        return super().pwrite(fd, data, offset)

    def fdatasync(self, fd):
        super().fdatasync(fd)
        path = self.path_of[fd]
        self.durable[path] = self._read(path)

    fsync = fdatasync

    def unlink(self, path):
        super().unlink(path)
        self.durable.pop(path, None)

    def crash(self):
        """The disk as the power loss left it."""
        for path, data in self.durable.items():
            if os.path.exists(path):
                with open(path, "wb") as f:
                    f.write(data)


@pytest.fixture
def crash_vfs():
    impl = CrashVfs()
    vfs.install(impl)
    try:
        yield impl
    finally:
        vfs.uninstall()


def _claim(uid):
    return PreparedClaim(uid=uid, state=PREPARE_COMPLETED, name=uid,
                         namespace="default",
                         devices=[{"device": f"gpu-{uid}"}])


def _settle(mgr, cp, uid, path):
    """One terminal commit of `uid` by `path`: a slot store, or a journal
    append that compacts (compaction lag 1) through a slot store."""
    cp.claims[uid] = _claim(uid)
    if path == "slots":
        mgr.store(cp)
    else:
        token = mgr.journal_commit(cp, present=[uid])
        mgr.journal_barrier(token)


@pytest.mark.parametrize("path", ["slots", "journal"])
def test_torn_primary_after_consecutive_terminal_stores(tmp_path, crash_vfs,
                                                        path):
    """Two settled claims, then a third store whose primary write tears:
    recovery must hold both settled claims (a regression past them would
    GC a running pod's CDI spec at the next start)."""
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, journal_compact_lag=1)
    cp = mgr.load_or_init()
    _settle(mgr, cp, "a", path)
    _settle(mgr, cp, "c", path)
    crash_vfs.tear = mgr.path
    with pytest.raises(PowerLoss):
        _settle(mgr, cp, "d", path)
    mgr.close()
    crash_vfs.crash()
    vfs.uninstall()
    try:
        recovered = CheckpointManager(d).load()
    except CheckpointError as e:
        pytest.fail(f"recovery lost every settled claim: {e}")
    assert recovered is not None, "recovery found no checkpoint at all"
    assert {"a", "c"} <= set(recovered.claims), sorted(recovered.claims)
    for uid in ("a", "c"):
        assert recovered.claims[uid].state == PREPARE_COMPLETED


def test_intent_then_terminal_pays_one_sync_per_store(tmp_path, crash_vfs):
    """The extra sync is paid only where no synced side slot covers the
    previous settled state: a terminal store right after an intent store
    (whose side slot is synced) still pays a single sync."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cp = mgr.load_or_init()
    cp.claims["a"] = PreparedClaim(uid="a")
    mgr.store(cp, intent=True)
    before = mgr.slot_syncs
    cp.claims["a"] = _claim("a")
    mgr.store(cp)
    assert mgr.slot_syncs - before == 1
    before = mgr.slot_syncs
    cp.claims["b"] = _claim("b")
    mgr.store(cp)
    assert mgr.slot_syncs - before == 2
    mgr.close()
