"""The port's drmc (tpu_dra_torch.analysis.drmc) against the reference's
(tpu_dra.analysis.drmc), and the port's gate at the reference gate's
sizes (hack/drmc.sh).

- scenario by scenario, the verdicts match: every gate scenario explores
  clean in both packages, and the two negative fixtures (racy-index,
  stale-read-probe) violate in both; each package installs and clears
  its own witness and work-queue hooks around its own runs;
- the crash scenarios recover at every enumerated point in both, each
  over at least 30 points (the counts differ: the port's checkpoint has
  its own durable ops);
- the port's violating schedule replays byte for byte, also through
  ``--replay-trace``;
- the controlled scheduler, the recording VFS and the work queue's
  model-checker hooks on the port's own parts;
- ``python -m tpu_dra_torch.analysis.drmc`` at budget 200 with the
  floors of 200 schedules and 30 crash points, then evict-churn,
  takeover-resync and shard-dispatch at budget 250, each held to 200.
"""

import json
import os
import threading

import pytest
import torch

from tpu_dra.analysis.drmc import crash as ref_crash
from tpu_dra.analysis.drmc import explore as ref_explore
from tpu_dra.analysis.drmc import scenarios as ref_scenarios
from tpu_dra_torch.analysis.drmc import crash as drmc_crash
from tpu_dra_torch.analysis.drmc import explore as drmc_explore
from tpu_dra_torch.analysis.drmc import scenarios as drmc_scenarios
from tpu_dra_torch.analysis.drmc.__main__ import main as drmc_main
from tpu_dra_torch.analysis.drmc.sched import (
    CooperativeScheduler, scenario_lock,
)
from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra import lockwitness as port_lw
from tpu_dra_torch.infra import vfs
from tpu_dra_torch.infra import workqueue

torch.set_num_threads(2)

NEGATIVE = ("racy-index", "stale-read-probe")


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Port registries reset; no witness export unless a test asks."""
    monkeypatch.delenv(port_lw.EXPORT_ENV, raising=False)
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


# ---------------------------------------------------------------------------
# Parity, scenario by scenario
# ---------------------------------------------------------------------------

def test_same_scenarios_in_the_same_groups():
    assert (set(drmc_scenarios.INTERLEAVING_SCENARIOS)
            == set(ref_scenarios.INTERLEAVING_SCENARIOS))
    assert drmc_scenarios.GATE_SCENARIOS == ref_scenarios.GATE_SCENARIOS
    assert (set(drmc_scenarios.CRASH_SCENARIOS)
            == set(ref_scenarios.CRASH_SCENARIOS))
    gate_and_negative = set(drmc_scenarios.GATE_SCENARIOS) | set(NEGATIVE)
    assert gate_and_negative == set(drmc_scenarios.INTERLEAVING_SCENARIOS)


@pytest.mark.parametrize("name",
                         sorted(ref_scenarios.INTERLEAVING_SCENARIOS))
def test_verdict_parity(name):
    ref = ref_explore.explore(ref_scenarios.INTERLEAVING_SCENARIOS[name](),
                              budget=30)
    port = drmc_explore.explore(
        drmc_scenarios.INTERLEAVING_SCENARIOS[name](), budget=30)
    assert port.ok == ref.ok == (name not in NEGATIVE), (
        port.to_dict(), ref.to_dict())
    assert port.schedules >= min(30, ref.schedules)


@pytest.mark.parametrize("name", sorted(ref_scenarios.CRASH_SCENARIOS))
def test_crash_parity(name):
    ref = ref_crash.enumerate_crashes(ref_scenarios.CRASH_SCENARIOS[name]())
    port = drmc_crash.enumerate_crashes(
        drmc_scenarios.CRASH_SCENARIOS[name]())
    for rep in (ref, port):
        assert rep.violations == [], "\n".join(rep.violations)
        assert rep.points_run == rep.points_enumerated >= 30
    kinds = " ".join(port.ops)
    probes = (("pwrite", "fdatasync", "write_text", "replace", "unlink",
               "flock") if name == "batch-prepare-crash"
              else ("pwrite", "fdatasync"))
    for probe in probes:
        assert probe in kinds, f"no {probe} op enumerated: {kinds}"


class TestViolationReplay:
    def test_racy_index_replays_byte_for_byte(self, capsys):
        report = drmc_explore.explore(drmc_scenarios.RacyIndexScenario(),
                                      budget=50)
        assert report.violation is not None
        assert any("allocated to" in v for v in report.violation.violations)
        recorded = {"trace": report.violation.trace,
                    "ops": report.violation.ops,
                    "violations": report.violation.violations}
        replayed = drmc_explore.replay(drmc_scenarios.RacyIndexScenario(),
                                       report.violation.trace)
        assert json.dumps(recorded, sort_keys=True) == json.dumps(
            {"trace": replayed.trace, "ops": replayed.ops,
             "violations": replayed.violations}, sort_keys=True)
        rc = drmc_main(["--scenario", "racy-index", "--replay-trace",
                        json.dumps(report.violation.trace)])
        assert rc == 1
        assert json.loads(capsys.readouterr().out) == recorded

    def test_stale_read_probe_replays_through_the_cli(self, capsys):
        report = drmc_explore.explore(
            drmc_scenarios.StaleReadProbeScenario(), budget=50)
        assert report.violation is not None
        rc = drmc_main(["--scenario", "stale-read-probe", "--replay-trace",
                        json.dumps(report.violation.trace)])
        assert rc == 1
        doc = json.loads(capsys.readouterr().out)
        assert doc["violations"] == report.violation.violations
        assert any("overrun" in v for v in doc["violations"])

    def test_shard_dispatch_overflow_is_reachable(self):
        seen_overflow = False
        for schedule in ([], [1, 0], [0, 0, 0, 0, 0]):
            scenario = drmc_scenarios.ShardDispatchScenario()
            _result, violations = drmc_explore.run_schedule(
                scenario, schedule=list(schedule))
            assert not violations
            seen_overflow = seen_overflow or bool(scenario._last_overflows)
        assert seen_overflow


# ---------------------------------------------------------------------------
# The substrate on the port's parts
# ---------------------------------------------------------------------------

class _CounterScenario:
    name = "counter"

    def build(self, sched):
        lock = scenario_lock()
        state = {"n": 0}

        def bump():
            with lock:
                state["n"] += 1

        sched.spawn("t1", bump)
        sched.spawn("t2", bump)
        return state

    def check(self, state):
        return [] if state["n"] == 2 else [f"lost update: n={state['n']}"]

    def cleanup(self, state):
        pass


class _DeadlockScenario:
    name = "deadlock"

    def build(self, sched):
        lock_a, lock_b = scenario_lock(), scenario_lock()

        def ab():
            with lock_a:
                with lock_b:
                    pass

        def ba():
            with lock_b:
                with lock_a:
                    pass

        sched.spawn("ab", ab)
        sched.spawn("ba", ba)
        return {}

    def check(self, ctx):
        return []

    def cleanup(self, ctx):
        pass


class TestControlledScheduler:
    def test_schedules_terminate_and_replay(self):
        report = drmc_explore.explore(_CounterScenario(), budget=50)
        assert report.schedules >= 2 and report.violation is None
        result, violations = drmc_explore.run_schedule(_CounterScenario())
        assert violations == []
        again = drmc_explore.replay(_CounterScenario(), result.trace)
        assert (again.trace, again.ops) == (result.trace, result.ops)

    def test_deadlock_is_detected(self):
        report = drmc_explore.explore(_DeadlockScenario(), budget=50)
        assert report.violation is not None
        text = "\n".join(report.violation.violations)
        assert "deadlock" in text or "lock-order cycle" in text

    def test_replay_divergence_is_loud(self):
        outcome = drmc_explore.replay(_CounterScenario(), [17])
        assert any("replay divergence" in v or "harness" in v
                   for v in outcome.violations)

    def test_hooks_cleared_after_a_run(self):
        drmc_explore.run_schedule(_CounterScenario())
        assert workqueue._drmc is None
        assert CooperativeScheduler().result.trace == []

    def test_metrics_are_bumped(self):
        from tpu_dra_torch.infra.metrics import DRMC_SCHEDULES

        before = DRMC_SCHEDULES.value(labels={"scenario": "counter"})
        drmc_explore.explore(_CounterScenario(), budget=5)
        assert DRMC_SCHEDULES.value(
            labels={"scenario": "counter"}) >= before + 1


class _RecordingHooks:
    """Work-queue hooks that see every yield point and control no thread
    (wait/notify fall through to the real Condition)."""

    def __init__(self):
        self.ops = []
        self.waits = self.notifies = 0

    def yield_op(self, kind, key):
        self.ops.append((kind, key))

    def wait(self, cond, timeout):
        self.waits += 1
        return False

    def notify(self, cond, all_waiters):
        self.notifies += 1
        return False


class TestWorkQueueHooks:
    def test_yield_points_and_fall_through(self):
        hooks = _RecordingHooks()
        q = workqueue.WorkQueue()
        done = threading.Event()
        workqueue.set_drmc_hooks(hooks)
        try:
            t = q.run_in_thread()
            q.enqueue(None, lambda _o: done.set(), key="k1")
            assert done.wait(5.0)
            q.shutdown()
            t.join(5.0)
        finally:
            workqueue.clear_drmc_hooks()
        assert not t.is_alive()
        assert ("queue.add", "k1") in hooks.ops
        assert ("queue.get", "k1") in hooks.ops
        assert hooks.notifies >= 2      # the enqueue's and shutdown's
        assert workqueue._drmc is None

    def test_controlled_wait_parks_in_the_model(self):
        """A queue consumer under the scheduler: its condition wait is
        modeled (a 'cond.wait' yield), so a schedule where the worker
        starts first still terminates with the item processed."""
        seen = []

        class Scenario:
            name = "queue-wait"

            def build(self, sched):
                q = workqueue.WorkQueue(
                    rate_limiter=drmc_scenarios._ZeroLimiter())

                def producer():
                    q.enqueue(None, lambda _o: seen.append(1), key="k")
                    q.shutdown()

                sched.spawn("worker", q.run)
                sched.spawn("producer", producer)
                return q

            def check(self, q):
                return []

            def cleanup(self, q):
                q.shutdown()

        result, violations = drmc_explore.run_schedule(Scenario())
        assert violations == []
        assert any("cond.wait" in op for op in result.ops)
        assert any("queue.add(k)" in op for op in result.ops)


class TestRecordingVfs:
    @staticmethod
    def _write_file(path, sync):
        fd = vfs.open_fd(str(path), os.O_RDWR | os.O_CREAT)
        vfs.pwrite(fd, b"hello world", 0)
        if sync:
            vfs.fdatasync(fd)
        vfs.close_fd(fd)

    def test_clean_image_drops_unsynced_writes(self, tmp_path):
        rec = drmc_crash.RecordingVfs()
        vfs.install(rec)
        try:
            rec.arm()
            self._write_file(tmp_path / "a", sync=False)
            self._write_file(tmp_path / "b", sync=True)
        finally:
            vfs.uninstall()
        rec.materialize_crash_image()
        assert not (tmp_path / "a").exists()
        assert (tmp_path / "b").read_bytes() == b"hello world"

    def test_unsynced_rename_reverts_in_clean_image(self, tmp_path):
        dst = tmp_path / "spec.json"
        dst.write_bytes(b"old")
        rec = drmc_crash.RecordingVfs()
        vfs.install(rec)
        try:
            rec.arm()
            vfs.write_text(str(tmp_path / "spec.json.tmp"), "new")
            vfs.replace(str(tmp_path / "spec.json.tmp"), str(dst))
        finally:
            vfs.uninstall()
        assert dst.read_bytes() == b"new"
        rec.materialize_crash_image()
        assert dst.read_bytes() == b"old"
        assert not (tmp_path / "spec.json.tmp").exists()

    def test_crashpoint_escapes_except_exception(self):
        assert not issubclass(drmc_crash.CrashPoint, Exception)
        assert issubclass(drmc_crash.CrashPoint, BaseException)


# ---------------------------------------------------------------------------
# The gate at the reference gate's sizes
# ---------------------------------------------------------------------------

class TestGate:
    def test_gate_at_full_size_with_floors(self, capsys, tmp_path,
                                           monkeypatch):
        edges = tmp_path / "edges.json"
        monkeypatch.setenv(port_lw.EXPORT_ENV, str(edges))
        rc = drmc_main(["--budget", "200", "--min-schedules", "200",
                        "--min-crash-points", "30", "--deadline", "180",
                        "--json"])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 0, doc["violations"]
        assert doc["distinct_total"] >= 200
        assert [e["scenario"] for e in doc["explore"]] == list(
            drmc_scenarios.GATE_SCENARIOS)
        for c in doc["crash"]:
            assert c["points_run"] == c["points_enumerated"] >= 30
        for name in ("evict-churn", "takeover-resync", "shard-dispatch"):
            rc = drmc_main(["--scenario", name, "--budget", "250",
                            "--min-schedules", "200", "--deadline", "120",
                            "--skip-crash", "--json"])
            doc = json.loads(capsys.readouterr().out)
            assert rc == 0, doc["violations"]
            assert doc["explore"][0]["distinct"] >= 200
        assert port_lw.load_edges(str(edges))

    def test_floor_is_enforced(self, capsys):
        rc = drmc_main(["--budget", "3", "--min-schedules", "1000",
                        "--skip-crash"])
        assert rc == 1
        assert "distinct interleavings" in capsys.readouterr().out

    def test_unknown_scenario_is_a_usage_error(self, capsys):
        assert drmc_main(["--scenario", "nope"]) == 2
