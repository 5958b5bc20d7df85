"""The port's scheduler at scale (tpu_dra_torch.simcluster.scheduler: the
worker pool, the sharded AllocationIndex, the chaos walk over it)
against the reference's (tpu_dra.simcluster.scheduler).

tests/test_scheduler_scale.py's TestShardedIndex (the cases
tests/test_torch_simcluster.py does not hold), TestMultiWorkerScheduler,
TestSchedulerChaos and TestChurnAtScale run on the port, devices named
after the map chip-N <-> gpu-N and chip-N-ss-1c-K <-> gpu-N-mig-1g10gb-K;
their @slow cases stay slow. Then parity: the same template pods on the
same inventory (testing.seed_sched_inventory of each package) through
reconcile_once give the same allocations (exact, after the map), and the
port's pool of four workers in event mode holds the reference's
invariants: every pod bound, no double allocation, the index equal to
cluster truth.
"""

import pytest

from tpu_dra_torch import bench
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS, EveryNth
from tpu_dra_torch.infra.metrics import SCHED_SNAPSHOT_CONFLICTS
from tpu_dra_torch.k8s import FakeCluster, PODS, RESOURCECLAIMS
from tpu_dra_torch.simcluster.chaos import (
    SchedulerChaosHarness, chip_conflicts,
)
from tpu_dra_torch.simcluster.scheduler import AllocationIndex, Scheduler
from tpu_dra_torch.testing import make_sched_pod, seed_sched_inventory


@pytest.fixture(autouse=True)
def _port_globals():
    """The port's own gates and faults (conftest resets only the
    reference's)."""
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


def make_cluster(nodes=4, gpus=2):
    c = FakeCluster()
    seed_sched_inventory(c, nodes=nodes, gpus_per_node=gpus)
    return c


def make_pod(c, name):
    return make_sched_pod(c, name)


class TestShardedIndex:
    """The sharded AllocationIndex: pool routing, optimistic snapshot
    commits, reservations, and shard-scoped resync."""

    DRIVER = "gpu.dev"

    def _claim(self, name, devices, pool="n0", rv=None):
        md = {"name": name, "namespace": "default"}
        if rv is not None:
            md["resourceVersion"] = str(rv)
        return {"metadata": md,
                "status": {"allocation": {"devices": {"results": [
                    {"driver": self.DRIVER, "pool": pool, "device": d}
                    for d in devices]}}}}

    def _two_pools_two_shards(self, idx):
        """Two pool names routing to different shards."""
        a = "n0"
        for i in range(1, 64):
            b = f"n{i}"
            if idx.shard_of(b) != idx.shard_of(a):
                return a, b
        raise AssertionError("no second shard found")

    def test_routing_is_stable_and_per_shard_diff_detects(self):
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        ca = self._claim("ca", ["gpu-0"], pool=a)
        cb = self._claim("cb", ["gpu-0"], pool=b)
        idx.apply(ca)
        idx.apply(cb)
        assert idx.diff_against([ca, cb]) == []
        # Dropping one claim from truth flags exactly its shard.
        diffs = idx.diff_against([ca])
        assert len(diffs) == 1 and f"shard {idx.shard_of(b)}" in diffs[0]

    def test_snapshot_commit_reserves_all_or_nothing(self):
        idx = AllocationIndex(n_shards=2)
        view = idx.snapshot("n0")
        assert not view.is_taken(self.DRIVER, "gpu-0")
        staged = [("default/ca", ((self.DRIVER, "n0", "gpu-0"),
                                  (self.DRIVER, "n0", "gpu-1")))]
        assert idx.try_commit("n0", staged)
        # Reserved devices are taken for every later snapshot/scan...
        assert idx.is_taken(self.DRIVER, "n0", "gpu-0")
        assert idx.snapshot("n0").is_taken(self.DRIVER, "gpu-1")
        # ...and a conflicting commit is refused atomically.
        c0 = SCHED_SNAPSHOT_CONFLICTS.value()
        assert not idx.try_commit("n0", [
            ("default/cb", ((self.DRIVER, "n0", "gpu-2"),)),
            ("default/cc", ((self.DRIVER, "n0", "gpu-1"),))])
        assert SCHED_SNAPSHOT_CONFLICTS.value() == c0 + 1
        assert not idx.is_taken(self.DRIVER, "n0", "gpu-2"), \
            "losing commit leaked a partial reservation"
        # Release returns the devices to the free set.
        idx.release("n0", ["default/ca"])
        assert not idx.is_taken(self.DRIVER, "n0", "gpu-0")

    def test_commit_respects_partition_semantics(self):
        idx = AllocationIndex(n_shards=2)
        idx.apply(self._claim("ca", ["gpu-0-mig-1g10gb-0"]))
        # The sibling MIG device coexists; the whole GPU does not.
        assert idx.try_commit("n0", [
            ("default/cb", ((self.DRIVER, "n0", "gpu-0-mig-1g10gb-1"),))])
        assert not idx.try_commit("n0", [
            ("default/cc", ((self.DRIVER, "n0", "gpu-0"),))])

    def test_commit_refused_while_shard_dirty_or_resyncing(self):
        idx = AllocationIndex(n_shards=2)
        sid = idx.shard_of("n0")
        staged = [("default/ca", ((self.DRIVER, "n0", "gpu-0"),))]
        idx.mark_shard_dirty(sid, "test")
        assert not idx.try_commit("n0", staged)
        idx.begin_resync(sid)  # clears dirty, sets resyncing
        assert not idx.try_commit("n0", staged)
        assert idx.resync_shard(sid, [])
        assert idx.try_commit("n0", staged)

    def test_resync_shard_rebuilds_only_its_shard(self):
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        idx.apply(self._claim("ca", ["gpu-0"], pool=a))
        idx.apply(self._claim("cb", ["gpu-0"], pool=b))
        # Rebuild a's shard from a listing that no longer has ca.
        idx.begin_resync(idx.shard_of(a))
        assert idx.resync_shard(idx.shard_of(a), [])
        assert not idx.is_taken(self.DRIVER, a, "gpu-0")
        assert idx.is_taken(self.DRIVER, b, "gpu-0"), \
            "sibling shard state lost to another shard's resync"

    def test_resync_preserves_reservations(self):
        idx = AllocationIndex(n_shards=2)
        assert idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-0"),))])
        sid = idx.shard_of("n0")
        idx.begin_resync(sid)
        assert idx.resync_shard(sid, [])
        assert idx.is_taken(self.DRIVER, "n0", "gpu-0"), \
            "in-flight reservation dropped by resync"

    def test_shard_swap_refused_when_mutations_raced(self):
        idx = AllocationIndex(n_shards=2)
        sid = idx.shard_of("n0")
        gen = idx.mutation_count(sid)
        idx.apply(self._claim("ca", ["gpu-0"], rv=5))
        assert not idx.resync_shard(sid, [], only_if_mutations=gen), \
            "stale resync snapshot silently clobbered a newer mutation"

    def test_commit_refuses_same_key_reservation_overwrite(self):
        """Two workers racing one shared unallocated claim (different
        pods, so per-key serialization does not order them): the second
        commit must CONFLICT — overwriting the live reservation would
        strand the first pick's refcounts when both release."""
        idx = AllocationIndex(n_shards=2)
        assert idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-0"),))])
        assert not idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-1"),))])
        idx.release("n0", ["default/ca"])
        assert not idx.is_taken(self.DRIVER, "n0", "gpu-0"), \
            "reservation refcount stranded after release"
        assert not idx.is_taken(self.DRIVER, "n0", "gpu-1")

    def test_commit_refuses_stale_copy_of_allocated_claim(self):
        """A commit staged from a stale claim copy (already allocated
        to other devices by a sibling worker) must conflict, not
        reserve a second set of devices for the same claim."""
        idx = AllocationIndex(n_shards=2)
        idx.apply(self._claim("ca", ["gpu-0"]))
        assert not idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-1"),))])

    def test_allocated_count_no_double_count_in_write_window(self):
        """Between the claim write's index apply and the caller's
        release the same entries are in _by_claim AND _reserved —
        allocated_count must count them once or the busy-node skip
        passes over free capacity."""
        idx = AllocationIndex(n_shards=2)
        assert idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-0"),))])
        idx.apply(self._claim("ca", ["gpu-0"], rv=3))
        assert idx.allocated_count("n0") == 1, "reservation double-counted"
        idx.release("n0", ["default/ca"])
        assert idx.allocated_count("n0") == 1

    def test_cross_pool_move_purges_old_shard(self):
        """A claim deallocated out-of-band and re-allocated on another
        pool must not orphan its old entries in the old pool's shard —
        and a stale replay carrying the OLD pool must neither resurrect
        them nor repoint the routing."""
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        idx.apply(self._claim("ca", ["gpu-0"], pool=a, rv=5))
        # The dealloc watch event is in flight but the re-allocation's
        # mutation-cache apply (rv 7, pool b) lands first.
        moved = self._claim("ca", ["gpu-0"], pool=b, rv=7)
        idx.apply(moved)
        assert not idx.is_taken(self.DRIVER, a, "gpu-0"), \
            "old pool's shard kept the moved claim's entries"
        assert idx.is_taken(self.DRIVER, b, "gpu-0")
        assert idx.diff_against([moved]) == []
        # The late dealloc (entry-less, rv 6) routes via the new home
        # and is stale-dropped; a replayed old ADDED (pool a, rv 4) is
        # stale-dropped in a's shard without repointing the home.
        idx.apply(self._claim("ca", [], pool=a, rv=6))
        idx.apply(self._claim("ca", ["gpu-0"], pool=a, rv=4))
        assert idx.diff_against([moved]) == []
        assert idx.entries_for("default/ca") == (
            (self.DRIVER, b, "gpu-0"),)
        # Delete converges both shards regardless of event/home skew.
        idx.remove(moved, force=True)
        assert idx.diff_against([]) == []

    def test_delayed_delete_replay_cannot_evict_recreated_claim(self):
        """Template claims reuse deterministic names, so delete +
        recreate reuses the claim key. A delayed DELETED watch replay
        carrying the OLD incarnation's body (old pool, old RV) routes
        its home-shard purge to the recreated claim's NEW shard — which
        must refuse it as stale rather than evict the live allocation
        (the index would report the devices free: double allocation)."""
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        idx.apply(self._claim("ca", ["gpu-0"], pool=a, rv=5))
        # Worker GC: the scheduler mirrors its own delete (rv 20).
        idx.remove(self._claim("ca", ["gpu-0"], pool=a, rv=20),
                   force=True)
        # Pod recreated; the new incarnation allocates on pool b.
        live = self._claim("ca", ["gpu-1"], pool=b, rv=21)
        idx.apply(live)
        # The old incarnation's DELETED event arrives late on the
        # informer thread.
        idx.remove(self._claim("ca", ["gpu-0"], pool=a, rv=20))
        assert idx.entries_for("default/ca") == (
            (self.DRIVER, b, "gpu-1"),)
        assert idx.diff_against([live]) == []

    def test_resync_prunes_homes_of_claims_deleted_while_divergent(self):
        """A claim deleted during a shard's divergence window (the
        dropped DELETE is why the resync runs) never re-enters the
        eviction FIFO — the rebuild must prune its routing home, or
        _homes grows one entry per such claim forever."""
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        ca = self._claim("ca", ["gpu-0"], pool=a, rv=5)
        cb = self._claim("cb", ["gpu-0"], pool=b, rv=6)
        idx.apply(ca)
        idx.apply(cb)
        sid = idx.shard_of(a)
        # ca was deleted out-of-band; the listing no longer has it.
        assert idx.resync_shard(sid, [cb])
        assert "default/ca" not in idx._homes
        assert "default/cb" in idx._homes  # other shard: untouched
        assert idx.diff_against([cb]) == []

    def test_claim_level_conflict_signals_stale_copy(self):
        """try_commit distinguishes claim-level conflicts (None: the
        caller's claim copy is stale, rescans are futile) from
        device-level ones (False: a fresh snapshot can win)."""
        idx = AllocationIndex(n_shards=2)
        assert idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-0"),))])
        shared = idx.try_commit("n0", [
            ("default/ca", ((self.DRIVER, "n0", "gpu-1"),))])
        assert shared is None
        taken = idx.try_commit("n0", [
            ("default/cb", ((self.DRIVER, "n0", "gpu-0"),))])
        assert taken is False

    def test_old_shard_eviction_keeps_moved_claims_routing(self, monkeypatch):
        """Watermark eviction in a claim's OLD shard (post cross-pool
        move) must not drop the live claim's routing home — or later
        entry-less deallocs/deletes become unroutable and the new shard
        keeps a phantom entry no dirty flag ever triggers a resync for."""
        from tpu_dra_torch.simcluster import scheduler as sched_mod

        monkeypatch.setattr(sched_mod._IndexShard, "RV_RETENTION", 4)
        idx = AllocationIndex(n_shards=4)
        a, b = self._two_pools_two_shards(idx)
        idx.apply(self._claim("ca", ["gpu-0"], pool=a, rv=5))
        moved = self._claim("ca", ["gpu-0"], pool=b, rv=7)
        idx.apply(moved)  # ca now lives in b's shard; a's FIFO holds it
        # Churn OTHER claims through a's shard past the retention
        # horizon, evicting ca from a's FIFO.
        for i in range(8):
            c = self._claim(f"f{i}", ["gpu-9"], pool=a, rv=10 + 2 * i)
            idx.apply(c)
            idx.remove(self._claim(f"f{i}", [], pool=a, rv=11 + 2 * i))
        # The late entry-less dealloc must still route to b's shard.
        idx.apply(self._claim("ca", [], pool=b, rv=9))
        assert idx.diff_against([]) == []
        assert not idx.dirty

    def test_allocated_count_includes_reservations(self):
        idx = AllocationIndex(n_shards=2)
        idx.apply(self._claim("ca", ["gpu-0", "gpu-1"]))
        assert idx.allocated_count("n0") == 2
        idx.try_commit("n0", [
            ("default/cb", ((self.DRIVER, "n0", "gpu-2"),))])
        assert idx.allocated_count("n0") == 3
        idx.release("n0", ["default/cb"])
        assert idx.allocated_count("n0") == 2


class TestMultiWorkerScheduler:
    """The worker pool end-to-end: churn at workers=4 with the chaos
    invariants, and the optimistic-commit conflict/requeue path."""

    def test_pool_churn_no_double_allocation(self):
        c = make_cluster(nodes=4, gpus=2)
        s = Scheduler(c, resync_interval=0.2, gc_sweep_interval=3600.0,
                      workers=4)
        s.start()
        try:
            assert len(s._pool) == 4
            for i in range(8):  # exactly capacity: all must place
                make_pod(c, f"mw{i}")
            assert c.wait_for(
                lambda: all(
                    c.get(PODS, f"mw{i}", "default")["spec"].get("nodeName")
                    for i in range(8)),
                timeout=15), "pool churn did not converge"
            claims = c.list(RESOURCECLAIMS, namespace="default")
            assert chip_conflicts(claims) == []
            assert s.verify_index() == []
        finally:
            s.stop()

    def test_commit_conflict_requeues_and_converges(self):
        """An armed sched.snapshot_commit fault refuses the first
        commits; the pod must retry against fresh snapshots and still
        place, with the conflict counter advancing."""
        c = make_cluster(nodes=2, gpus=2)
        s = Scheduler(c, resync_interval=0.1, gc_sweep_interval=3600.0,
                      workers=2)
        c0 = SCHED_SNAPSHOT_CONFLICTS.value()
        s.start()
        try:
            with FAULTS.armed("sched.snapshot_commit", EveryNth(2)):
                for i in range(3):
                    make_pod(c, f"cf{i}")
                assert c.wait_for(
                    lambda: all(
                        c.get(PODS, f"cf{i}", "default")["spec"].get(
                            "nodeName") for i in range(3)),
                    timeout=15), "conflicts did not resolve via requeue"
            assert SCHED_SNAPSHOT_CONFLICTS.value() > c0, \
                "fault never exercised the conflict path"
            assert s.verify_index() == []
            assert chip_conflicts(
                c.list(RESOURCECLAIMS, namespace="default")) == []
        finally:
            s.stop()

    def test_shard_apply_fault_triggers_shard_scoped_resync(self):
        from tpu_dra_torch.infra.metrics import SCHED_SHARD_RESYNCS as SR
        c = make_cluster(nodes=2, gpus=2)
        s = Scheduler(c, resync_interval=0.1, gc_sweep_interval=3600.0,
                      workers=2)
        r0 = SR.value()
        s.start()
        try:
            with FAULTS.armed("sched.shard_apply", EveryNth(3)):
                for i in range(4):
                    make_pod(c, f"sa{i}")
                assert c.wait_for(
                    lambda: all(
                        c.get(PODS, f"sa{i}", "default")["spec"].get(
                            "nodeName") for i in range(4)),
                    timeout=15), "churn did not converge under shard faults"
            assert c.wait_for(lambda: not s._index.dirty, timeout=5)
            assert SR.value() > r0, \
                "shard faults never routed through the shard resync"
            assert s.verify_index() == []
        finally:
            s.stop()


def test_late_own_write_after_delete_leaves_no_phantom():
    """A worker's claim write whose mirror lands after the claim was
    deleted (GC of a deleted pod racing the pod's allocation on another
    worker, the node-death walk's race) must not resurrect the claim in
    the informer cache: a later resync rebuilds the index from that
    cache, and a resurrected claim would hold its devices forever."""
    import copy
    import time

    c = make_cluster(nodes=2, gpus=2)
    s = Scheduler(c, resync_interval=0.2, gc_sweep_interval=3600.0,
                  workers=2)
    s.start()
    try:
        make_pod(c, "p0")
        assert c.wait_for(lambda: c.get(PODS, "p0", "default")["spec"].get(
            "nodeName"), timeout=10)
        late = copy.deepcopy(c.get(RESOURCECLAIMS, "p0-t", "default"))
        c.delete(PODS, "p0", "default")
        assert c.wait_for(lambda: not c.list(RESOURCECLAIMS,
                                             namespace="default"),
                          timeout=10)
        assert c.wait_for(lambda: s._informers["claims"].lister.get(
            "p0-t", "default") is None, timeout=10)
        s._after_claim_write(late)
        assert s._informers["claims"].lister.get("p0-t", "default") is None
        s.request_resync("test")
        assert c.wait_for(lambda: not s._index.dirty, timeout=10)
        time.sleep(0.2)
        assert s.verify_index() == []
    finally:
        s.stop()


def test_resync_keeps_deleted_claim_tombstone_against_queued_delta():
    """The node-death walk's phantom, replayed in order: an allocated
    claim's delta waits in its pool's informer shard FIFO while the
    claim is deleted; the DELETED delta is shed (sched.watch_shard_dispatch)
    and the shard's resync rebuilds from a cache that no longer holds
    the claim. The queued allocated delta then runs last and must be
    refused as stale, or its devices stay taken forever."""
    import threading

    from tpu_dra_torch.infra.faults import OneShot
    from tpu_dra_torch.infra.metrics import SCHED_SHARD_RESYNCS
    from tpu_dra_torch.simcluster.scheduler import claim_entries

    c = make_cluster(nodes=2, gpus=2)
    s = Scheduler(c, resync_interval=3600.0, gc_sweep_interval=3600.0,
                  workers=2)
    s.start()
    gate, held = threading.Event(), threading.Event()

    def hold():
        held.set()
        gate.wait()

    try:
        make_pod(c, "p0")
        assert c.wait_for(lambda: c.get(PODS, "p0", "default")["spec"].get(
            "nodeName"), timeout=10)
        claim = c.get(RESOURCECLAIMS, "p0-t", "default")
        pool = claim_entries(claim)[0][1]
        sid = s._index.shard_of(pool)
        claims_inf = s._informers["claims"]
        claims_inf._dispatcher.flush()
        assert s.verify_index() == []
        # Hold the pool's shard, then queue an allocated delta behind it.
        claims_inf._dispatcher.offer(sid, hold)
        assert held.wait(timeout=10)
        claim["metadata"].setdefault("annotations", {})["touch"] = "1"
        c.update(RESOURCECLAIMS, claim, "default")
        assert c.wait_for(lambda: claims_inf._dispatcher.depth(sid) == 1,
                          timeout=10), "the allocated delta never queued"
        r0 = SCHED_SHARD_RESYNCS.value()
        with FAULTS.armed("sched.watch_shard_dispatch", OneShot()):
            c.delete(PODS, "p0", "default")
            assert c.wait_for(lambda: not c.list(RESOURCECLAIMS,
                                                 namespace="default"),
                              timeout=10)
            assert c.wait_for(lambda: SCHED_SHARD_RESYNCS.value() > r0
                              and not s._index.dirty, timeout=10), \
                "the shed delete never reached the shard resync"
        gate.set()
        assert claims_inf._dispatcher.flush(timeout=10)
        assert s.verify_index() == []
    finally:
        gate.set()
        s.stop()


class TestSchedulerChaos:
    def test_one_seeded_walk_clean(self):
        report = SchedulerChaosHarness(11).run(n_events=30)
        assert report.ok, report.violations

    @pytest.mark.slow
    def test_seed_matrix_clean(self):
        from tpu_dra_torch.simcluster.chaos import run_sched_matrix
        out = run_sched_matrix(list(range(25)), n_events=60)
        assert out["violations"] == [], out["violations"]


@pytest.mark.slow
class TestChurnAtScale:
    def test_acceptance_configuration(self):
        """The reference's acceptance gate: >= 100 nodes, >= 500 pod
        lifecycles, zero steady-state relists, compile count bounded by
        distinct expressions."""
        out = bench.bench_sched_churn(n_nodes=100, n_pods=500,
                                      gpus_per_node=4)
        assert out["sched_churn_nodes"] >= 100
        assert out["sched_churn_pods"] >= 500
        assert out["sched_full_relists"] == 0
        assert out["sched_cel_compiles"] <= out["sched_cel_distinct_exprs"]
        assert "sched_churn_gc_leak" not in out


# ---------------------------------------------------------------------------
# Parity with the reference's scheduler
# ---------------------------------------------------------------------------

def _allocations(cluster, claims_gvr, to_port=lambda d: d):
    return {cl["metadata"]["name"]: sorted(
                (r["pool"], to_port(r["device"])) for r in
                ((cl.get("status") or {}).get("allocation") or {})
                .get("devices", {}).get("results", []))
            for cl in cluster.list(claims_gvr, namespace="default")}


def test_reconcile_once_allocations_match_reference():
    """The same template pods, created and deleted in the same order, on
    each package's seed_sched_inventory (3 nodes x 2): every
    reconcile_once pass leaves the same claims allocated to the same
    (node, device) pairs after the chip-N -> gpu-N map (exact)."""
    from tpu_dra.k8s import FakeCluster as RefCluster
    from tpu_dra.k8s import resources as ref_res
    from tpu_dra.simcluster.scheduler import Scheduler as RefScheduler
    from tpu_dra.testing import make_sched_pod as ref_make_pod
    from tpu_dra.testing import seed_sched_inventory as ref_seed

    ref, port = RefCluster(), FakeCluster()
    ref_seed(ref, nodes=3, chips_per_node=2)
    seed_sched_inventory(port, nodes=3, gpus_per_node=2)
    rs, ps = RefScheduler(ref), Scheduler(port)

    def to_port(dev):
        return "gpu-" + dev.split("-")[1]

    script = ([("create", f"p{i}") for i in range(5)]
              + [("delete", "p1"), ("delete", "p3")]
              + [("create", f"q{i}") for i in range(3)])
    for verb, name in script:
        if verb == "create":
            ref_make_pod(ref, name)
            make_sched_pod(port, name)
        else:
            ref.delete(ref_res.PODS, name, "default")
            port.delete(PODS, name, "default")
        rs.reconcile_once()
        ps.reconcile_once()
        want = _allocations(ref, ref_res.RESOURCECLAIMS, to_port)
        assert _allocations(port, RESOURCECLAIMS) == want
    assert sum(1 for v in want.values() if v) == 6   # 6 GPUs, all taken


def test_event_mode_pool_holds_reference_invariants():
    """workers=4 in event mode over churn (creates, deletes, more
    creates past the freed capacity): every live pod bound with its claim
    on its node, no double allocation (chip_conflicts, the reference's
    partition rule), no claim of a deleted pod left, and the index equal
    to cluster truth."""
    c = make_cluster(nodes=3, gpus=4)
    s = Scheduler(c, resync_interval=0.2, gc_sweep_interval=3600.0,
                  workers=4)
    s.start()
    try:
        for i in range(12):
            make_pod(c, f"ev{i}")
        for i in range(0, 12, 3):
            c.delete(PODS, f"ev{i}", "default")
        for i in range(4):
            make_pod(c, f"late{i}")
        live = [f"ev{i}" for i in range(12) if i % 3] + \
            [f"late{i}" for i in range(4)]

        def settled():
            claims = c.list(RESOURCECLAIMS, namespace="default")
            owners = {(cl["metadata"].get("annotations") or {}).get(
                "sim/owner-pod") for cl in claims}
            if owners != set(live):
                return False
            for name in live:
                node = c.get(PODS, name, "default")["spec"].get("nodeName")
                cl = next(x for x in claims if (x["metadata"].get(
                    "annotations") or {}).get("sim/owner-pod") == name)
                pools = {r["pool"] for r in ((cl.get("status") or {}).get(
                    "allocation") or {}).get("devices", {}).get(
                        "results", [])}
                if not node or pools != {node}:
                    return False
            return True

        assert c.wait_for(settled, timeout=20), "pool churn did not settle"
        assert chip_conflicts(c.list(RESOURCECLAIMS,
                                     namespace="default")) == []
        assert c.wait_for(lambda: s.verify_index() == [], timeout=5), \
            s.verify_index()
    finally:
        s.stop()
