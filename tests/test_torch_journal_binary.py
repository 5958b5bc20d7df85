"""Port parity: the reference's binary-journal cases
(tests/test_journal_binary.py) over tpu_dra_torch.gpuplugin.checkpoint.

Every case of the reference's file runs here against the port's journal,
the CDI handler and fault registry the port carries (tpu_dra_torch.cdi,
tpu_dra_torch.infra.faults), except TestLegacyUpgrade: the port reads no
v1 or seq-less JSON journal (it never wrote one; the checkpoint module's
docstring), so the legacy-upgrade cases have nothing to hold.
"""

from __future__ import annotations

import json
import os
import threading

import pytest

from tpu_dra_torch.gpuplugin.checkpoint import (
    PREPARE_COMPLETED,
    CheckpointManager,
    PreparedClaim,
    _REC_DELTA,
    _dec_value,
    _enc_value,
    _frame_record,
)


def _commit(mgr, cp, **kw):
    tok = mgr.journal_commit(cp, **kw)
    mgr.journal_barrier(tok)


class TestBinaryCodec:
    CASES = [
        None, True, False, 0, 1, -1, 2**40, -(2**40), 2**80, -(2**90),
        0.0, -2.5, 1e300, "", "plain", "unié☃de", "x" * 4096,
        b"", b"\x00\xff" * 7, [], [1, "two", None, [3.5, {"k": "v"}]],
        {}, {"b": 1, "a": 2}, {"nested": {"list": [True, {"d": []}]}},
    ]

    def test_roundtrip(self):
        for v in self.CASES:
            out = bytearray()
            _enc_value(v, out)
            got, end = _dec_value(bytes(out), 0)
            assert end == len(out)
            assert got == v
            assert type(got) is type(v)

    def test_dict_order_preserved(self):
        # CRC covers raw payload bytes, so no canonical ordering is
        # imposed — the decode must hand back exactly what went in.
        v = {"z": 1, "a": 2, "m": 3}
        out = bytearray()
        _enc_value(v, out)
        got, _ = _dec_value(bytes(out), 0)
        assert list(got) == ["z", "a", "m"]

    def test_unknown_record_type_skipped(self, tmp_path):
        # Forward compat: a future record type in the chain must not
        # break this reader — it skips the record and keeps replaying.
        mgr = CheckpointManager(str(tmp_path / "cp"))
        cp = mgr.load_or_init()
        cp.claims["a"] = PreparedClaim(uid="a", state=PREPARE_COMPLETED)
        _commit(mgr, cp, present=["a"])
        seg, tail = mgr.active_segment_path, mgr._journal_tail
        mgr.close()
        payload = bytearray()
        _enc_value({"future": True}, payload)
        framed = _frame_record(999, 200, bytes(payload))
        cp_bytes = bytearray()
        _enc_value({"upsert": {"b": {"state": PREPARE_COMPLETED,
                                     "devices": []}}}, cp_bytes)
        framed2 = _frame_record(1000, _REC_DELTA, bytes(cp_bytes))
        with open(seg, "r+b") as f:
            f.seek(tail)
            f.write(framed + framed2)
        mgr2 = CheckpointManager(str(tmp_path / "cp"))
        cp2 = mgr2.load()
        assert sorted(cp2.claims) == ["a", "b"]
        mgr2.close()


class TestTornTailFuzz:
    """Corrupt/truncate the binary journal at EVERY
    byte offset of the last record. Recovery never throws, never
    resurrects the rolled-back claim, and drops only the torn suffix."""

    def _build(self, tmp_path):
        d = str(tmp_path / "cp")
        mgr = CheckpointManager(d)
        cp = mgr.load_or_init()
        cp.claims["a"] = PreparedClaim(uid="a", state=PREPARE_COMPLETED)
        cp.claims["b"] = PreparedClaim(uid="b", state=PREPARE_COMPLETED)
        _commit(mgr, cp, present=["a", "b"])
        # The rollback whose resurrection the fuzz hunts for.
        del cp.claims["b"]
        _commit(mgr, cp, absent=["b"])
        last_start = mgr._journal_tail
        cp.claims["c"] = PreparedClaim(uid="c", state=PREPARE_COMPLETED)
        _commit(mgr, cp, present=["c"])
        last_end = mgr._journal_tail
        seg = mgr.active_segment_path
        mgr.close()
        with open(seg, "rb") as f:
            pristine = f.read()
        return d, seg, pristine, last_start, last_end

    def _recover(self, d, seg, data):
        with open(seg, "wb") as f:
            f.write(data)
        mgr = CheckpointManager(d)
        try:
            cp = mgr.load()
        finally:
            mgr.close()
        return cp

    def test_truncate_every_offset(self, tmp_path):
        d, seg, pristine, start, end = self._build(tmp_path)
        for off in range(start, end + 1):
            cp = self._recover(d, seg, pristine[:off])
            assert "a" in cp.claims, f"prefix record lost at cut {off}"
            assert "b" not in cp.claims, \
                f"rolled-back claim resurrected at cut {off}"
            if off == end:
                assert "c" in cp.claims
            else:
                assert "c" not in cp.claims, \
                    f"torn record applied at cut {off}"

    def test_corrupt_every_offset(self, tmp_path):
        d, seg, pristine, start, end = self._build(tmp_path)
        for off in range(start, end):
            mutated = bytearray(pristine)
            mutated[off] ^= 0x5A
            cp = self._recover(d, seg, bytes(mutated))
            assert "a" in cp.claims, f"prefix record lost at byte {off}"
            assert "b" not in cp.claims, \
                f"rolled-back claim resurrected at byte {off}"
            # A flipped byte anywhere in the record fails its CRC (or
            # its header sanity bounds): the record must drop, with
            # exactly one legal exception — the length field growing
            # into the zero tail can only yield a CRC miss, still a
            # drop. Either way 'c' must never half-apply; a surviving
            # 'c' would mean the checksum missed the corruption.
            assert "c" not in cp.claims, \
                f"corrupted record applied at byte {off}"

    def test_garbage_beyond_tail_dropped(self, tmp_path):
        d, seg, pristine, start, end = self._build(tmp_path)
        cp = self._recover(d, seg, pristine + b"\x7f" * 33)
        assert sorted(cp.claims) == ["a", "c"]


class TestRotation:
    def test_size_roll_keeps_chain_until_compaction(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp"),
                                segment_roll_bytes=256,
                                journal_compact_lag=1000)
        cp = mgr.load_or_init()
        for i in range(8):
            cp.claims[f"r{i}"] = PreparedClaim(uid=f"r{i}",
                                               state=PREPARE_COMPLETED)
            _commit(mgr, cp, present=[f"r{i}"])
        assert mgr.journal_rotations >= 2
        assert mgr.journal_compactions == 0
        assert len(mgr.journal_segment_paths()) >= 3
        mgr.close()
        mgr2 = CheckpointManager(str(tmp_path / "cp"))
        assert sorted(mgr2.load().claims) == sorted(f"r{i}"
                                                    for i in range(8))
        mgr2.close()

    def test_compaction_retires_whole_chain(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp"),
                                segment_roll_bytes=256,
                                journal_compact_lag=6)
        cp = mgr.load_or_init()
        for i in range(6):
            cp.claims[f"r{i}"] = PreparedClaim(uid=f"r{i}",
                                               state=PREPARE_COMPLETED)
            _commit(mgr, cp, present=[f"r{i}"])
        assert mgr.journal_compactions == 1
        assert len(mgr.journal_segment_paths()) == 1
        assert mgr.journal_lag == 0
        mgr.close()

    def test_segment_preallocated_and_zeroed(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp"))
        cp = mgr.load_or_init()
        cp.claims["a"] = PreparedClaim(uid="a", state=PREPARE_COMPLETED)
        _commit(mgr, cp, present=["a"])
        seg, tail = mgr.active_segment_path, mgr._journal_tail
        mgr.close()
        size = os.path.getsize(seg)
        assert size >= CheckpointManager.JOURNAL_ALLOC
        with open(seg, "rb") as f:
            data = f.read()
        assert data.count(0, tail) == size - tail  # clean zero tail


class TestAdaptiveWindow:
    def test_sequential_load_never_holds(self, tmp_path):
        """The never-holds-idle tripwire at unit tier: strictly
        sequential commit/barrier pairs present no co-committer
        evidence, so the leader must sync immediately every time."""
        mgr = CheckpointManager(str(tmp_path / "cp"))
        cp = mgr.load_or_init()
        for i in range(40):
            cp.claims[f"s{i}"] = PreparedClaim(uid=f"s{i}",
                                               state=PREPARE_COMPLETED)
            _commit(mgr, cp, present=[f"s{i}"])
        assert mgr.journal_window_holds == 0
        assert mgr.journal_group_syncs >= 40
        mgr.close()

    def test_urgent_barrier_never_holds(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp"))
        cp = mgr.load_or_init()
        # Fake a hot arrival rate: even then, urgent must not hold.
        mgr._arrival_ewma = 1e-6
        for i in range(5):
            cp.claims[f"u{i}"] = PreparedClaim(uid=f"u{i}",
                                               state=PREPARE_COMPLETED)
            tok = mgr.journal_commit(cp, present=[f"u{i}"])
            mgr.journal_barrier(tok, urgent=True)
        assert mgr.journal_window_holds == 0
        mgr.close()

    def test_concurrent_commits_coalesce_and_stay_durable(self, tmp_path):
        """Hammer the barrier from 8 threads: every barrier's token must
        be covered by a sync (durability), the claim set must survive
        recovery, and the engineered window must not deadlock or starve
        anyone. Coalescing magnitude is gated at the perf tier (timing-
        dependent); correctness is gated here."""
        mgr = CheckpointManager(str(tmp_path / "cp"),
                                journal_compact_lag=10**6)
        cp = mgr.load_or_init()
        lock = threading.Lock()
        errors = []

        def worker(wid):
            try:
                for i in range(25):
                    uid = f"w{wid}-{i}"
                    with lock:
                        cp.claims[uid] = PreparedClaim(
                            uid=uid, state=PREPARE_COMPLETED)
                        tok = mgr.journal_commit(cp, present=[uid])
                    mgr.journal_barrier(tok)
                    assert mgr._synced_seq >= tok
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert mgr.journal_appends == 200
        # Coalescing may vary with scheduling, but syncs can never
        # exceed appends, and the adaptive window must not have
        # OVER-held (every hold must have been repaid by a shared
        # sync): holds <= appends - group_syncs is the accounting
        # identity for "each hold coalesced at least one extra append".
        assert mgr.journal_group_syncs <= mgr.journal_appends
        mgr.close()
        mgr2 = CheckpointManager(str(tmp_path / "cp"))
        assert len(mgr2.load().claims) == 200
        mgr2.close()


class TestCDITemplateCache:
    def _handler(self, tmp_path):
        from tpu_dra_torch.cdi.handler import CDIHandler
        return CDIHandler(str(tmp_path / "cdi"),
                          driver_root=str(tmp_path / "drv"))

    # The reference's shapes with the port's namesakes: CUDA_VISIBLE_DEVICES
    # for TPU_VISIBLE_CHIPS, a CUDA library for libtpu, /dev/nvidia0 for
    # /dev/accel0.
    SHAPES = [
        dict(env={"CUDA_VISIBLE_DEVICES": "0,1",
                  "TRACEPARENT": "00-abc-def-01"},
             mounts=None, device_nodes=None),
        dict(env={"A": 'quote" backslash\\ newline\n tab\t'},
             mounts=[{"hostPath": "/lib/libcuda.so.1",
                      "containerPath": "/lib/libcuda.so.1",
                      "options": ["ro", "bind"]}],
             device_nodes=None),
        dict(env={"X": "1", "Y": "2"},
             mounts=[{"hostPath": "/l", "containerPath": "/c"}],
             device_nodes=[{"path": "/dev/nvidia0",
                            "hostPath": "/dev/nvidia0"}]),
        dict(env={}, mounts=None, device_nodes=None),
    ]

    def test_byte_identity_with_direct_serialization(self, tmp_path):
        h = self._handler(tmp_path)
        for i, shape in enumerate(self.SHAPES):
            for uid in (f"uid-{i}", f"uid-{i}-again", "we{ird}\"uid"):
                _, text = h.serialize_claim_spec(
                    uid, shape["env"], mounts=shape["mounts"],
                    device_nodes=shape["device_nodes"])
                ref = h._serialize_claim_spec_direct(
                    uid, shape["env"], shape["mounts"],
                    shape["device_nodes"])
                assert text == ref
                json.loads(text)   # and it parses

    def test_cache_keyed_on_shape_content(self, tmp_path):
        h = self._handler(tmp_path)
        m1 = [{"hostPath": "/a", "containerPath": "/a"}]
        m2 = [{"hostPath": "/b", "containerPath": "/b"}]
        h.serialize_claim_spec("u1", {"X": "1"}, mounts=m1)
        h.serialize_claim_spec("u2", {"X": "2"}, mounts=m1)
        assert len(h._claim_tpl_cache) == 1   # env/uid changes: no miss
        _, text = h.serialize_claim_spec("u3", {"X": "3"}, mounts=m2)
        assert len(h._claim_tpl_cache) == 2   # mount change: new shape
        assert json.loads(text)["devices"][0]["containerEdits"][
            "mounts"] == m2

    def test_cache_bounded(self, tmp_path):
        h = self._handler(tmp_path)
        for i in range(h._TPL_CACHE_MAX + 10):
            h.serialize_claim_spec(
                f"u{i}", {"X": "1"},
                mounts=[{"hostPath": f"/m{i}", "containerPath": "/c"}])
        assert len(h._claim_tpl_cache) <= h._TPL_CACHE_MAX

    def test_fault_site_still_fires(self, tmp_path):
        from tpu_dra_torch.infra.faults import FAULTS, Always, FaultInjected
        h = self._handler(tmp_path)
        with FAULTS.armed("cdi.claim_write", Always()):
            with pytest.raises(FaultInjected):
                h.serialize_claim_spec("u1", {"X": "1"})
