"""The port's lock-order witness (tpu_dra_torch.infra.lockwitness)
against the reference's (tpu_dra.infra.lockwitness).

Every class of tests/test_lockwitness.py, run on the port's witness:
cycle detection on the acquisition-order graph, hold-time outliers,
RLock reentrancy, the same-class self-nest carve-out, Condition interop,
windows, the refcounted install() patch and the edge export. Then:

- parity: one lock script (the same creation order, and the same
  acquisition order on two threads) compiled under a tpu_dra path and
  under a tpu_dra_torch path and run under each package's installed
  witness gives the same edge set and the same cycles once each
  package's prefix is stripped from the keys (exact);
- coexistence: the two witnesses installed and uninstalled in both
  orders, nested and interleaved, leave threading.Lock and
  threading.RLock the original constructors; a lock created in a
  tpu_dra_torch frame is witnessed by the port's witness only.
"""

import threading

import pytest

from tpu_dra.infra import lockwitness as ref_lw
from tpu_dra_torch.infra import lockwitness as lw

# The original constructors, as the reference's witness captured them at
# its import (before any install, also under a witnessed session).
ORIGINAL_LOCK = ref_lw._real_lock
ORIGINAL_RLOCK = ref_lw._real_rlock


@pytest.fixture
def witness():
    """A private witness so tests never touch the process-global graph
    (which a harness or a witnessed session may be using)."""
    w = lw.LockWitness()
    saved = lw.WITNESS
    lw.WITNESS = w
    yield w
    lw.WITNESS = saved


def _lock(key):
    return lw.WitnessLock(threading._allocate_lock(), key)


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def _nested(outer, inner):
    def fn():
        with outer:
            with inner:
                pass
    return fn


class TestCycleDetection:
    def test_opposite_order_on_two_threads_is_a_cycle(self, witness):
        A, B = _lock("mod.py:1"), _lock("mod.py:2")

        def t1():
            with A:
                with B:
                    pass

        def t2():
            with B:
                with A:
                    pass

        _in_thread(t1)
        assert witness.cycles() == []  # one order alone is fine
        _in_thread(t2)
        cycles = witness.cycles()
        assert len(cycles) == 1
        assert "mod.py:1" in cycles[0] and "mod.py:2" in cycles[0]
        assert "potential deadlock" in cycles[0]

    def test_consistent_order_is_acyclic(self, witness):
        A, B, C = (_lock(f"mod.py:{i}") for i in (1, 2, 3))

        def t():
            with A:
                with B:
                    with C:
                        pass

        for _ in range(3):
            _in_thread(t)
        assert witness.cycles() == []
        assert witness.violations(max_hold_s=5.0) == []

    def test_transitive_cycle_through_three_locks(self, witness):
        A, B, C = (_lock(f"mod.py:{i}") for i in (1, 2, 3))
        _in_thread(_nested(A, B))
        _in_thread(_nested(B, C))
        assert witness.cycles() == []
        _in_thread(_nested(C, A))
        cycles = witness.cycles()
        assert len(cycles) == 1
        assert all(k in cycles[0] for k in
                   ("mod.py:1", "mod.py:2", "mod.py:3"))

    def test_duplicate_cycle_reported_once(self, witness):
        A, B = _lock("m.py:1"), _lock("m.py:2")

        def forward():
            with A:
                with B:
                    pass

        def backward():
            with B:
                with A:
                    pass

        _in_thread(forward)
        for _ in range(3):
            _in_thread(backward)
        assert len(witness.cycles()) == 1

    def test_same_class_nesting_is_self_nest_not_cycle(self, witness):
        # Two per-GPU locks share a creation site; sorted-order nested
        # acquisition must not read as a deadlock.
        L1, L2 = _lock("gpus.py:9"), _lock("gpus.py:9")

        def t():
            with L1:
                with L2:
                    pass

        _in_thread(t)
        assert witness.cycles() == []
        assert witness.stats()["gpus.py:9"]["self_nests"] == 1


class TestHoldTracking:
    def test_hold_outlier_reported(self, witness):
        L = _lock("slow.py:1")
        with L:
            import time
            time.sleep(0.03)
        out = witness.hold_outliers(0.01)
        assert len(out) == 1 and "slow.py:1" in out[0]
        assert witness.hold_outliers(1.0) == []

    def test_violations_combines_cycles_and_outliers(self, witness):
        L = _lock("slow.py:2")
        with L:
            import time
            time.sleep(0.03)
        assert witness.violations() == []          # no threshold: cycles only
        assert len(witness.violations(max_hold_s=0.01)) == 1

    def test_rlock_reentry_no_self_edge_single_hold_time(self, witness):
        R = lw.WitnessRLock(threading.RLock(), "re.py:1")
        with R:
            with R:
                pass
        assert witness.cycles() == []
        st = witness.stats()["re.py:1"]
        assert st["acquisitions"] == 1 and st["self_nests"] == 0

    def test_reset_clears_graph(self, witness):
        A, B = _lock("r.py:1"), _lock("r.py:2")
        _in_thread(_nested(A, B))
        _in_thread(_nested(B, A))
        assert witness.cycles()
        witness.reset()
        assert witness.cycles() == []
        assert witness.edges() == {}


class TestConditionInterop:
    def test_condition_wait_releases_witnessed_rlock(self, witness):
        R = lw.WitnessRLock(threading.RLock(), "cond.py:1")
        cond = threading.Condition(R)
        other = _lock("cond.py:2")

        def waiter():
            with cond:
                cond.wait(timeout=0.05)

        def toucher():
            # If wait() failed to pop the witness's held stack, this
            # acquisition would add edges from a lock the thread no
            # longer holds.
            with other:
                pass

        _in_thread(waiter)
        _in_thread(toucher)
        assert witness.cycles() == []
        # wait() went through _release_save/_acquire_restore: the rlock
        # was released and re-acquired, so two acquisitions.
        assert witness.stats()["cond.py:1"]["acquisitions"] == 2

    def test_reentrant_cond_wait_not_booked_as_hold(self, witness):
        # cond.wait() under REENTRANT hold fully releases the RLock: the
        # wait must not count as lock-hold time.
        R = lw.WitnessRLock(threading.RLock(), "cond.py:9")
        cond = threading.Condition(R)

        def reentrant_waiter():
            with R:           # depth 1
                with cond:    # depth 2 (same inner RLock)
                    cond.wait(timeout=0.05)

        _in_thread(reentrant_waiter)
        assert witness.cycles() == []
        assert witness.hold_outliers(0.02) == []
        # Fully re-acquired at depth 2 after the wait, fully released
        # on exit: no residual held state, 2 windows booked.
        assert witness.stats()["cond.py:9"]["acquisitions"] == 2


class TestWindows:
    def test_violations_since_reports_only_the_window(self, witness):
        import time
        pre = _lock("w.py:1")
        with pre:
            time.sleep(0.03)          # pre-window outlier
        snap = witness.snapshot()
        assert witness.violations_since(snap, max_hold_s=0.01) == []
        A, B = _lock("w.py:4"), _lock("w.py:5")
        _in_thread(_nested(A, B))
        _in_thread(_nested(B, A))     # in-window cycle
        out = witness.violations_since(snap, max_hold_s=0.01)
        assert any("w.py:4" in v or "w.py:5" in v for v in out)
        assert not any("w.py:1" in v for v in out)  # pre-window outlier excluded
        # the un-windowed view still sees everything
        assert any("w.py:1" in v
                   for v in witness.violations(max_hold_s=0.01))


class TestInstall:
    def test_factory_wraps_tpu_dra_torch_created_locks_only(self):
        from tpu_dra_torch.infra.workqueue import (
            ExponentialFailureRateLimiter,
        )
        lw.install(reset=False)
        try:
            rl = ExponentialFailureRateLimiter(0.1, 1.0)
            assert isinstance(rl._lock, lw.WitnessLock)
            assert rl._lock._key.startswith("tpu_dra_torch/infra/workqueue.py:")
            here = threading.Lock()  # created from tests/: left raw
            assert not isinstance(here, lw.WitnessLock)
        finally:
            lw.uninstall()

    def test_refcounted_uninstall(self):
        was_installed = lw.installed()
        lw.install(reset=False)
        lw.install(reset=False)
        lw.uninstall()
        assert lw.installed()
        lw.uninstall()
        assert lw.installed() == was_installed

    def test_witnessed_stack_runs_clean(self):
        """A real driver-stack slice (the port's workqueue) under the
        witness: no cycles, sane stats."""
        from tpu_dra_torch.infra.workqueue import WorkQueue
        w = lw.LockWitness()
        saved = lw.WITNESS
        lw.WITNESS = w
        lw.install(reset=False)
        try:
            q = WorkQueue()
            done = threading.Event()
            q.enqueue("x", lambda obj: done.set(), key="k")
            t = q.run_in_thread()
            assert done.wait(5)
            q.shutdown()
            t.join(timeout=5)
            assert w.cycles() == []
            assert any(k.startswith("tpu_dra_torch/infra/workqueue.py:")
                       for k in w.stats())
        finally:
            lw.uninstall()
            lw.WITNESS = saved


class TestEdgeExport:
    """export_edges/load_edges: merge semantics let several runs
    accumulate into one file."""

    def _observe(self, witness):
        a, b = _lock("m.py:1"), _lock("m.py:2")
        _in_thread(_nested(a, b))

    def test_export_and_load_roundtrip(self, witness, tmp_path):
        self._observe(witness)
        out = tmp_path / "edges.json"
        assert lw.export_edges(str(out)) == str(out)
        assert lw.load_edges(str(out)) == [("m.py:1", "m.py:2")]

    def test_export_merges_across_runs(self, witness, tmp_path):
        out = tmp_path / "edges.json"
        self._observe(witness)
        lw.export_edges(str(out))
        witness.reset()
        c, d = _lock("m.py:3"), _lock("m.py:4")
        _in_thread(_nested(c, d))
        lw.export_edges(str(out))
        assert lw.load_edges(str(out)) == [
            ("m.py:1", "m.py:2"), ("m.py:3", "m.py:4")]

    def test_export_noop_without_destination(self, witness, monkeypatch):
        monkeypatch.delenv(lw.EXPORT_ENV, raising=False)
        self._observe(witness)
        assert lw.export_edges() is None

    def test_env_destination_and_uninstall_flush(self, witness, tmp_path,
                                                 monkeypatch):
        out = tmp_path / "edges.json"
        monkeypatch.setenv(lw.EXPORT_ENV, str(out))
        self._observe(witness)
        was_installed = lw.installed()
        lw.install(reset=False)
        lw.uninstall()  # refcount zero (unless an enclosing install holds)
        if was_installed:
            lw.export_edges()
        assert lw.load_edges(str(out)) == [("m.py:1", "m.py:2")]

    def test_garbled_existing_file_is_replaced(self, witness, tmp_path):
        out = tmp_path / "edges.json"
        out.write_text("{not json")
        self._observe(witness)
        lw.export_edges(str(out))
        assert lw.load_edges(str(out)) == [("m.py:1", "m.py:2")]


class TestYieldHook:
    def test_hook_sees_acquire_and_release_in_order(self, witness):
        events = []
        lw.set_yield_hook(lambda kind, key, ident, blocking:
                          events.append((kind, key)))
        try:
            L = _lock("y.py:1")
            with L:
                pass
        finally:
            lw.clear_yield_hook()
        with _lock("y.py:2"):
            pass   # no hook: nothing recorded
        assert events == [("lock.acquire", "y.py:1"),
                          ("lock.acquired", "y.py:1"),
                          ("lock.release", "y.py:1")]


# ---------------------------------------------------------------------------
# Parity with the reference's witness
# ---------------------------------------------------------------------------

# Creation order A, B, C (one line each), then thread 1 nests A -> B -> C
# and thread 2 nests C -> A: edges A->B, A->C, B->C, C->A, and the cycles
# they close.
_SCRIPT = """\
import threading
A = threading.Lock()
B = threading.RLock()
C = threading.Lock()

def one():
    with A:
        with B:
            with B:
                with C:
                    pass

def two():
    with C:
        with A:
            pass

for fn in (one, two):
    t = threading.Thread(target=fn, name=fn.__name__)
    t.start()
    t.join(10)
"""


def _run_script(mod, package_dir, tmp_path):
    """Compile the script under <tmp>/<package_dir>/script.py, run it with
    `mod`'s witness installed on a private graph, return (edges, cycles)
    with the package prefix stripped from every key."""
    path = str(tmp_path / package_dir / "script.py")
    code = compile(_SCRIPT, path, "exec")
    w = mod.LockWitness()
    saved = mod.WITNESS
    mod.WITNESS = w
    mod.install(reset=False)
    try:
        exec(code, {"__name__": "witness_script"})
    finally:
        mod.uninstall()
        mod.WITNESS = saved
    prefix = package_dir + "/"

    def strip(key):
        assert key.startswith(prefix), key
        return key[len(prefix):]

    edges = {(strip(s), strip(d)): n for (s, d), n in w.edges().items()}
    cycles = [c.replace(prefix, "") for c in w.cycles()]
    return edges, cycles


def test_edges_and_cycles_match_reference(tmp_path):
    ref_edges, ref_cycles = _run_script(ref_lw, "tpu_dra", tmp_path)
    port_edges, port_cycles = _run_script(lw, "tpu_dra_torch", tmp_path)
    assert port_edges == ref_edges
    assert set(port_edges) == {
        ("script.py:2", "script.py:3"), ("script.py:2", "script.py:4"),
        ("script.py:3", "script.py:4"), ("script.py:4", "script.py:2")}
    assert port_cycles == ref_cycles and len(port_cycles) == 1
    assert "potential deadlock" in port_cycles[0]


# ---------------------------------------------------------------------------
# Two witnesses in one process
# ---------------------------------------------------------------------------

def _restored():
    return (threading.Lock is ORIGINAL_LOCK
            and threading.RLock is ORIGINAL_RLOCK)


@pytest.fixture
def unpatched():
    """These cases start from the original constructors; under a
    session-wide reference install (TPU_DRA_LOCK_WITNESS=1) they would
    start from its factory, so they take it off for their duration."""
    depth = 0
    while ref_lw.installed():
        ref_lw.uninstall()
        depth += 1
    assert not lw.installed() and _restored()
    yield
    for _ in range(depth):
        ref_lw.install(reset=False)


@pytest.mark.parametrize("order", [
    # nested: the inner witness leaves first
    ("ref+", "port+", "port-", "ref-"),
    ("port+", "ref+", "ref-", "port-"),
    # interleaved: the outer witness leaves first
    ("ref+", "port+", "ref-", "port-"),
    ("port+", "ref+", "port-", "ref-"),
])
def test_install_orders_restore_the_constructors(unpatched, order):
    mods = {"ref": ref_lw, "port": lw}
    try:
        for step in order:
            mod = mods[step[:-1]]
            if step.endswith("+"):
                mod.install(reset=False)
            else:
                mod.uninstall()
        assert not lw.installed() and not ref_lw.installed()
        assert _restored(), (threading.Lock, threading.RLock)
    finally:
        for mod in (lw, ref_lw):
            while mod.installed():
                mod.uninstall()
        threading.Lock, threading.RLock = ORIGINAL_LOCK, ORIGINAL_RLOCK


def test_port_locks_are_witnessed_by_the_port_only(unpatched):
    """With only the port's witness installed, a lock made in a
    tpu_dra_torch frame is the port's WitnessLock and a lock made in a
    tpu_dra frame is left raw; with the reference's installed beneath
    it, the port's factory still answers first."""
    from tpu_dra.infra.workqueue import (
        ExponentialFailureRateLimiter as RefLimiter,
    )
    from tpu_dra_torch.infra.workqueue import ExponentialFailureRateLimiter

    for enclosing in (False, True):
        if enclosing:
            ref_lw.install(reset=False)
        lw.install(reset=False)
        try:
            port_lock = ExponentialFailureRateLimiter(0.1, 1.0)._lock
            ref_lock = RefLimiter(0.1, 1.0)._lock
        finally:
            lw.uninstall()
            if enclosing:
                ref_lw.uninstall()
        assert isinstance(port_lock, lw.WitnessLock)
        assert not isinstance(port_lock, ref_lw.WitnessLock)
        assert not isinstance(ref_lock, (lw.WitnessLock, ref_lw.WitnessLock))
        assert _restored()
