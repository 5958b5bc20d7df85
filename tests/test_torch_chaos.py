"""The port's chaos tier (tpu_dra_torch.simcluster.chaos) against the
reference's (tpu_dra.simcluster.chaos).

Every class of tests/test_chaos.py, run on the port: seeded plugin-walk
schedules at seeds 0-2 with zero violations, faults that fire and fail
real operations, the dropped-watch + API-flake scenario at seeds 0 and 3,
the transactional-prepare rollback cases on the GPU stack, the
crash-recovery probe, the node-death walk at seeds 0-1 (and its kills,
set by the seed alone), and the proof-gated prune of the topology walk;
the soak stays @slow. Claims name gpu-N devices of gpu.dev; the
reference's chip-N of tpu.dev map onto them.

Parity: chip_conflicts gives the same findings on the same claims (device
names mapped); the topology walk's _prune_wedged and the node-death
walk's _placeable decide the same on the same fixed worlds; each
harness's REARM_SITES equal the reference's; ChaosReport.to_dict(), the
chaos.main summary and measure_daemon_crash_recovery have the
reference's keys.
"""

import json
import random

import pytest

from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS, EveryNth, OneShot
from tpu_dra_torch.simcluster import chaos
from tpu_dra_torch.simcluster.chaos import (
    ChaosHarness, measure_daemon_crash_recovery, run_schedule,
    run_watch_flake_scenario,
)


@pytest.fixture(autouse=True)
def _port_globals():
    """The port's own gates and faults (conftest resets only the
    reference's)."""
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


class TestChaosSchedules:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_schedule_converges_with_zero_violations(self, seed):
        report = run_schedule(seed, n_events=25)
        assert report.violations == []
        assert report.events == 25

    def test_faults_actually_fired(self):
        """A chaos tier that injects nothing proves nothing: across a
        few seeds, faults must both fire and fail real operations."""
        fired = failed = 0
        for seed in range(4):
            r = run_schedule(seed, n_events=30)
            assert r.violations == []
            fired += sum(r.injected.values())
            failed += r.failed_attempts
        assert fired > 0
        assert failed > 0


class TestWatchFlakeRecovery:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_dropped_watch_plus_api_flake_recovers(self, seed):
        """Watch drops + API flakes, then the informer cache converges to
        cluster truth with no manual relist."""
        assert run_watch_flake_scenario(seed=seed) == []


class TestPrepareRollback:
    """Transactional prepare: a mid-claim failure unwinds CDI specs and
    checkpoint entries so the retry is idempotent from a clean slate."""

    def _harness(self):
        return ChaosHarness(seed=99)

    def test_cdi_write_failure_rolls_back_cleanly(self):
        h = self._harness()
        try:
            obj = h.make_claim([0, 1])
            with FAULTS.armed("cdi.claim_write", OneShot()):
                err = h.attempt_prepare(obj)
            assert err is not None
            uid = obj["metadata"]["uid"]
            # Clean unwind: no checkpoint entry, no CDI spec on disk.
            assert uid not in h.state.prepared_claim_uids()
            assert uid not in h.cdi.list_claim_uids()
            # Retry from scratch succeeds.
            assert h.attempt_prepare(obj) is None
            assert uid in h.cdi.list_claim_uids()
        finally:
            FAULTS.reset()
            h.close()

    def test_terminal_store_failure_rolls_back(self):
        """A failed PrepareCompleted store unwinds instead of leaving the
        claim applied-but-not-durable."""
        h = self._harness()
        try:
            obj = h.make_claim([0])
            uid = obj["metadata"]["uid"]
            # load_or_init already stored once; the claim's intent store
            # is skipped for non-hazardous configs, so the next store IS
            # the terminal one.
            with FAULTS.armed("checkpoint.store", EveryNth(1)):
                err = h.attempt_prepare(obj)
            assert err is not None and "checkpoint store" in err
            assert uid not in h.cdi.list_claim_uids()
            assert h.attempt_prepare(obj) is None
        finally:
            FAULTS.reset()
            h.close()

    def test_rollback_failure_degrades_to_deferred_unwind(self):
        """When the unwind itself cannot persist, the claim stays
        PrepareStarted for a later unprepare — never silently dropped."""
        from tpu_dra_torch.gpuplugin.checkpoint import PREPARE_STARTED
        h = self._harness()
        try:
            obj = h.make_claim([0])
            uid = obj["metadata"]["uid"]
            # Every store fails: the terminal store errors AND the
            # rollback's store errors — deferred-unwind path.
            with FAULTS.armed("checkpoint.store", EveryNth(1)), \
                    FAULTS.armed("cdi.claim_write", EveryNth(1)):
                err = h.attempt_prepare(obj)
            assert err is not None and "rollback deferred" in err
            snap = h.state.checkpoint_snapshot()
            assert snap.claims[uid].state == PREPARE_STARTED
            # Unprepare finishes the rollback once faults clear.
            assert h.attempt_unprepare(obj) is None
            assert uid not in h.state.prepared_claim_uids()
        finally:
            FAULTS.reset()
            h.close()

    def test_batch_apply_fault_mixed_outcome_converges(self):
        """The batch path's own injection site: every other member of a
        multi-claim prepare RPC fails mid-apply. Survivors must be
        prepared and durable, losers cleanly rolled back, and the whole
        set must converge once the fault clears."""
        h = self._harness()
        try:
            with FAULTS.armed("prepare.batch_apply", EveryNth(2)):
                for _ in range(4):
                    h._op_prepare_batch()
            assert h.report.batches > 0
            # Losers landed in pending; drive them to ready.
            for uid in sorted(h.pending):
                obj = h.pending.pop(uid)
                assert h.attempt_prepare(obj) is None
                h.prepared[uid] = obj
            # Every claim's spec + checkpoint entry present exactly once.
            assert set(h.cdi.list_claim_uids()) == set(h.prepared)
            assert set(h.state.prepared_claim_uids()) == set(h.prepared)
        finally:
            FAULTS.reset()
            h.close()

    def test_torn_checkpoint_slot_recovers_on_restart(self):
        """checkpoint.corrupt tears one slot per store; load() must
        recover the full claim state from the surviving slots."""
        from tpu_dra_torch.simcluster.chaos import _corrupt_one_slot
        h = self._harness()
        try:
            obj = h.make_claim([0, 1, 2])
            with FAULTS.armed("checkpoint.corrupt", EveryNth(1),
                              action=_corrupt_one_slot(random.Random(5))):
                assert h.attempt_prepare(obj) is None
            h.crash_restart()
            uid = obj["metadata"]["uid"]
            assert uid in h.state.prepared_claim_uids()
            assert h.attempt_prepare(obj) is None  # idempotent re-prepare
        finally:
            FAULTS.reset()
            h.close()


class TestCrashRecoveryProbe:
    def test_measures_sane_latency(self):
        out = measure_daemon_crash_recovery(n=3)
        assert out["chaos_recovery_crashes"] == 3
        assert 0 < out["chaos_recovery_p50_ms"] < 60_000


class TestNodeDeathWalk:
    """Failure-domain recovery racing pod churn: a couple of seeds
    through the full walk; the 25-seed matrix is @slow."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_schedule_converges_with_zero_violations(self, seed):
        from tpu_dra_torch.simcluster.chaos import run_nodedeath_schedule
        report = run_nodedeath_schedule(seed, n_events=40)
        assert report.violations == []

    def test_node_deaths_actually_happen(self):
        """A node-death walk that never kills anything proves nothing.
        The walk's ops are set by its seed alone, so each seed kills the
        same number of nodes in every run, however loaded the host."""
        from tpu_dra_torch.simcluster.chaos import run_nodedeath_schedule
        kills = []
        for seed in range(3):
            r = run_nodedeath_schedule(seed, n_events=40)
            assert r.violations == []
            kills.append(r.crashes)
        assert sum(kills) > 0
        assert kills == [2, 2, 3]


class TestPruneWedged:
    """TopologyChaosHarness._prune_wedged is a PROOF-gated prune: a pod
    that IS satisfiable on some node's free coordinates must never be
    pruned — including when the capacity it needs is momentarily held
    by a DEAD pod's claim that GC is about to free (un-pruned, not
    leaked)."""

    def _harness(self):
        from tpu_dra_torch.simcluster.chaos import TopologyChaosHarness
        h = TopologyChaosHarness(7, nodes=1, gpus_per_node=8)
        # Freeze the control plane: the test drives cluster state by
        # hand and calls _prune_wedged directly.
        h.sched.stop()
        return h

    def test_placeable_pod_is_not_pruned(self):
        from tpu_dra_torch.testing import make_sched_pod
        h = self._harness()
        try:
            make_sched_pod(h.cluster, "pw-ok", template="tmpl2")
            h.live["pw-ok"] = None
            h.pod_gpus["pw-ok"] = 2
            h._prune_wedged()
            assert "pw-ok" in h.live, \
                "placeable pod pruned (free inventory admits a 2-block)"
        finally:
            h.close()

    def test_pod_blocked_by_dead_pods_claim_is_not_pruned(self):
        """Capacity held by a dead pod's claim (GC pending) must not
        count as taken — pruning on it would delete a pod the scheduler
        can legitimately place once the drain completes."""
        from tpu_dra_torch.k8s import PODS
        from tpu_dra_torch.testing import make_sched_pod

        h = self._harness()
        try:
            h.cluster.create(*_dead_claim(range(8)), namespace="default")
            make_sched_pod(h.cluster, "pw-wait", template="tmpl4")
            h.live["pw-wait"] = None
            h.pod_gpus["pw-wait"] = 4
            h._prune_wedged()
            assert "pw-wait" in h.live, \
                "pod pruned on capacity a dead pod's claim will free"
            # Counter-case: the same claim owned by a LIVE pod is real
            # contention — with zero free coordinates the pod is
            # provably wedged and the prune must fire.
            h.cluster.create(PODS, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "ghost", "namespace": "default"},
                "spec": {"containers": [{"name": "c", "image": "x"}]}})
            h._prune_wedged()
            assert "pw-wait" not in h.live, \
                "provably-unplaceable pod not pruned"
        finally:
            h.close()


@pytest.mark.slow
class TestChaosSoak:
    def test_25_seeded_schedules_zero_violations(self):
        from tpu_dra_torch.simcluster.chaos import run_matrix
        summary = run_matrix(list(range(25)), n_events=60)
        assert summary["violations"] == []
        assert summary["schedules"] == 25
        assert sum(summary["injected"].values()) > 0

    def test_watch_flake_matrix(self):
        for seed in range(10):
            assert run_watch_flake_scenario(seed=seed) == [], \
                f"seed {seed} failed to recover"

    def test_node_death_matrix(self):
        from tpu_dra_torch.simcluster.chaos import run_nodedeath_matrix
        summary = run_nodedeath_matrix(list(range(25)), n_events=60)
        assert summary["violations"] == []
        assert summary["schedules"] == 25


# ---------------------------------------------------------------------------
# Parity with the reference's chaos tier
# ---------------------------------------------------------------------------

def _dead_claim(gpus, owner="ghost", ref=False):
    """(gvr, object) of a claim owned by `owner` holding `gpus` on n0, in
    the port's resources and names or (ref=True) the reference's."""
    if ref:
        from tpu_dra.k8s import RESOURCECLAIMS as gvr
        driver, dev, req = "tpu.dev", "chip-{}", "tpu"
    else:
        from tpu_dra_torch.k8s import RESOURCECLAIMS as gvr
        driver, dev, req = "gpu.dev", "gpu-{}", "gpu"
    return gvr, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": f"claim-of-{owner}", "namespace": "default",
                     "annotations": {"sim/owner-pod": owner}},
        "spec": {"devices": {"requests": [{"name": req}]}},
        "status": {"allocation": {"devices": {"results": [
            {"request": req, "driver": driver, "pool": "n0",
             "device": dev.format(i)} for i in gpus], "config": []}}}}


def _claims(rng, ref):
    """Random allocated claims over 2 pools x 4 GPUs, whole or MIG (the
    reference's subslices), some overlapping."""
    out = []
    for k in range(rng.randrange(2, 7)):
        results = []
        for _ in range(rng.randrange(1, 3)):
            pool = rng.choice(("n0", "n1"))
            gpu = rng.randrange(4)
            part = rng.choice((None, None, 0, 1))
            if ref:
                name = (f"chip-{gpu}" if part is None
                        else f"chip-{gpu}-ss-1c-{part}")
                driver = "tpu.dev"
            else:
                name = (f"gpu-{gpu}" if part is None
                        else f"gpu-{gpu}-mig-1g10gb-{part}")
                driver = "gpu.dev"
            results.append({"driver": driver, "pool": pool,
                            "device": name})
        out.append({"metadata": {"name": f"c{k}", "namespace": "default"},
                    "status": {"allocation": {"devices": {
                        "results": results}}}})
    return out


@pytest.mark.parametrize("seed", range(8))
def test_chip_conflicts_match_reference(seed):
    """The same claims (device names mapped) give the same findings, in
    the same order, once the names in the messages are mapped back."""
    from tpu_dra.simcluster.chaos import chip_conflicts as ref_conflicts

    ref = ref_conflicts(_claims(random.Random(seed), ref=True))
    port = chaos.chip_conflicts(_claims(random.Random(seed), ref=False))

    def norm(msg):
        return (msg.replace("tpu.dev", "gpu.dev").replace("chip-", "gpu-")
                .replace("-ss-1c-", "-mig-1g10gb-")
                .replace("chip (", "GPU (").replace("subslices", "MIG devices"))

    assert port == [norm(m) for m in ref]


def test_conflicts_found_at_all():
    """The parity above is not vacuous: among its seeds some claims
    conflict, on a device and on a whole GPU against a MIG device."""
    found = [m for seed in range(8)
             for m in chaos.chip_conflicts(
                 _claims(random.Random(seed), ref=False))]
    assert any(m.startswith("device ") for m in found)
    assert any(m.startswith("GPU ") for m in found)


def _frozen(harness_cls, **kw):
    h = harness_cls(7, **kw)
    h.sched.stop()
    return h


@pytest.mark.parametrize("world", ["free", "dead_owner", "live_owner",
                                   "two_free"])
def test_prune_and_placeable_decide_as_reference(world):
    """One fixed world per case on a single 8-device node of each
    package: no claim; a dead pod's claim on every device; the same claim
    owned by a live pod; a live pod's claim on six devices. A pod of 4
    is pruned by the topology walk, and called placeable by the
    node-death walk, exactly when the reference's are."""
    from tpu_dra.k8s import PODS as REF_PODS
    from tpu_dra.simcluster.chaos import (
        NodeDeathChaosHarness as RefNodeDeath,
        TopologyChaosHarness as RefTopology,
    )
    from tpu_dra.testing import make_sched_pod as ref_make_pod
    from tpu_dra_torch.k8s import PODS
    from tpu_dra_torch.simcluster.chaos import (
        NodeDeathChaosHarness, TopologyChaosHarness,
    )
    from tpu_dra_torch.testing import make_sched_pod

    held = {"free": None, "dead_owner": range(8), "live_owner": range(8),
            "two_free": range(6)}[world]
    decisions = {}
    for side, topo_cls, nd_cls, kw, pods_gvr, mk in (
            ("ref", RefTopology, RefNodeDeath, {"chips_per_node": 8},
             REF_PODS, ref_make_pod),
            ("port", TopologyChaosHarness, NodeDeathChaosHarness,
             {"gpus_per_node": 8}, PODS, make_sched_pod)):
        out = []
        for cls in (topo_cls, nd_cls):
            h = _frozen(cls, nodes=1, **kw)
            try:
                if held is not None:
                    gvr, obj = _dead_claim(held, ref=side == "ref")
                    h.cluster.create(gvr, obj, namespace="default")
                if world in ("live_owner", "two_free"):
                    h.cluster.create(pods_gvr, {
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "ghost",
                                     "namespace": "default"},
                        "spec": {"containers": [{"name": "c",
                                                 "image": "x"}]}})
                if cls in (topo_cls,):
                    mk(h.cluster, "want4", template="tmpl4")
                    h.live["want4"] = None
                    sizes = h.pod_chips if side == "ref" else h.pod_gpus
                    sizes["want4"] = 4
                    h._prune_wedged()
                    out.append("kept" if "want4" in h.live else "pruned")
                elif side == "ref":
                    out.append(h._placeable(4, h._published(),
                                            h._nodes_alive()))
                else:
                    out.append(h._placeable(4, h._nodes_alive()))
            finally:
                h.close()
        decisions[side] = out
    assert decisions["port"] == decisions["ref"]
    assert decisions["port"] == {
        "free": ["kept", True], "dead_owner": ["kept", True],
        "live_owner": ["pruned", False],
        "two_free": ["pruned", False]}[world]


def test_rearm_sites_match_reference():
    from tpu_dra.simcluster import chaos as ref_chaos
    assert chaos.CHAOS_SITES == ref_chaos.CHAOS_SITES
    for name in ("SchedulerChaosHarness", "LeaderKillChaosHarness",
                 "TopologyChaosHarness", "NodeDeathChaosHarness"):
        assert getattr(chaos, name).REARM_SITES == \
            getattr(ref_chaos, name).REARM_SITES, name
    assert chaos.REARM_SITES["plugin"] == ref_chaos.CHAOS_SITES


def test_report_and_recovery_keys_match_reference():
    from tpu_dra.simcluster import chaos as ref_chaos
    assert set(chaos.ChaosReport(seed=1).to_dict()) == \
        set(ref_chaos.ChaosReport(seed=1).to_dict())
    port = measure_daemon_crash_recovery(n=1)
    ref = ref_chaos.measure_daemon_crash_recovery(n=1)
    assert set(port) == set(ref)


def test_main_summary_keys_match_reference(capsys):
    """chaos.main at one seed of a few events: the port's summary has
    the reference's keys, at the top and in every walk, and exits 0."""
    from tpu_dra.simcluster import chaos as ref_chaos

    assert ref_chaos.main(["--seeds", "1", "--events", "6"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert chaos.main(["--seeds", "1", "--events", "6"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert set(port) == set(ref)
    for walk in ("scheduler", "topology", "node_death", "leader_kill"):
        assert set(port[walk]) == set(ref[walk]), walk
        assert port[walk]["violations"] == []
    assert port["violations"] == [] and port["watch_flake_violations"] == []
