"""The port's draracer (tpu_dra_torch.analysis.raceanalysis, R9-R11)
against the reference's, and the port's lock-order graph.

- parity: every analyzer call of the reference's
  tests/test_raceanalysis.py, replayed through both packages from
  tests/torch_analysis_corpus.json (test_torch_dralint.py says how it is
  recorded): equal findings, and for its ``race_run`` trees the same
  static lock-order graph and guarded-by table;
- the witness's own locks: the port's ``lockwitness`` creates them
  through the ``threading.Lock`` alias R11 resolves (its acquisitions
  are modeled, no finding), and falls back to ``_thread``'s constructors
  when another witness had patched ``threading`` at its import;
- the port's tree (one scan): R9-R11 clean, the static graph acyclic
  and populated, and observed ⊆ static for the edges a drmc run and a
  scheduler chaos walk export from the port's witness, on the CPU.
"""

import importlib.util
import sys
import threading
from pathlib import Path

import pytest
import torch

from test_torch_dralint import REPO, corpus_cases, replay
from tpu_dra_torch.analysis import core as port_core
from tpu_dra_torch.analysis import lint_sources as port_lint_sources
from tpu_dra_torch.analysis import raceanalysis as port_race
from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra import lockwitness as port_lw

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


@pytest.mark.parametrize("case", corpus_cases("tests/test_raceanalysis.py"))
def test_parity(case, tmp_path):
    ref, port = replay(case, tmp_path)
    assert port == ref


class TestWitnessLockCreation:
    WITNESS = REPO / "tpu_dra_torch" / "infra" / "lockwitness.py"

    def test_r11_resolves_the_witness_graph_lock(self):
        rel = "tpu_dra_torch/infra/lockwitness.py"
        out = port_lint_sources({rel: self.WITNESS.read_text()},
                                rule_ids={"R11"})
        assert out == []

    def test_raw_constructors_are_the_unpatched_ones(self):
        import _thread

        from tpu_dra.infra import lockwitness as ref_lw

        assert port_lw._real_lock is _thread.allocate_lock
        assert port_lw._real_rlock in (ref_lw._real_rlock, _thread.RLock)

    def test_foreign_factories_at_import_are_passed_over(self, monkeypatch):
        """A witness that patched threading before this module's import
        (the reference's, under a witnessed session) must not become the
        port witness's raw constructor."""
        import _thread

        def foreign_lock():
            raise AssertionError("foreign factory called")

        monkeypatch.setattr(threading, "Lock", foreign_lock)
        monkeypatch.setattr(threading, "RLock", foreign_lock)
        spec = importlib.util.spec_from_file_location(
            "_lockwitness_copy", self.WITNESS)
        mod = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, spec.name, mod)
        spec.loader.exec_module(mod)
        assert mod._real_lock is _thread.allocate_lock
        assert mod._real_rlock is _thread.RLock
        mod.LockWitness()   # its graph lock: a raw lock, no factory call


class TestPortTree:
    def test_graph_acyclic_r9_r11_clean_and_observed_within_static(
            self, tmp_path, monkeypatch):
        from tpu_dra_torch.analysis.drmc import explore
        from tpu_dra_torch.analysis.drmc.scenarios import (
            INTERLEAVING_SCENARIOS,
        )
        from tpu_dra_torch.simcluster.chaos import run_sched_schedule

        drmc_edges = tmp_path / "drmc-edges.json"
        chaos_edges = tmp_path / "chaos-edges.json"
        monkeypatch.setenv(port_lw.EXPORT_ENV, str(drmc_edges))
        for name in ("sched-churn", "batch-prepare", "evict-churn"):
            rep = explore.explore(INTERLEAVING_SCENARIOS[name](), budget=25)
            assert rep.ok, rep.to_dict()
        monkeypatch.setenv(port_lw.EXPORT_ENV, str(chaos_edges))
        walk = run_sched_schedule(11, 40)
        assert walk.ok, walk.violations
        monkeypatch.delenv(port_lw.EXPORT_ENV)

        active = port_core.all_rules()
        report = port_core.run(port_core.default_paths(REPO), root=REPO,
                               rules=active, use_cache=False)
        race = [f for f in report.findings
                if f.rule in ("R9", "R10", "R11")]
        assert race == [], [f.format() for f in race]
        rule = next(r for r in active
                    if isinstance(r, port_race.RaceAnalysis))
        assert len(rule.static_edges) >= 20
        assert len(port_race.locks_report(rule)) > 0
        for path in (drmc_edges, chaos_edges):
            observed = port_lw.load_edges(str(path))
            assert observed, path
            assert all(s.startswith("tpu_dra_torch/")
                       and d.startswith("tpu_dra_torch/")
                       for s, d in observed)
            assert port_race.check_witness(rule, observed) == []

    def test_unexplained_edge_is_reported(self):
        rule = port_race.RaceAnalysis()
        rule.static_edges = {("a.py:1", "a.py:2"): ["f"]}
        out = port_race.check_witness(
            rule, [("a.py:1", "a.py:2"), ("a.py:2", "b.py:9")])
        assert len(out) == 1 and "unknown to the static analyzer" in out[0]


def test_scanned_tree_is_rooted_at_the_ports_registries():
    root = port_core.find_root(Path(__file__))
    assert root == REPO
    assert (root / "tpu_dra_torch" / "infra" / "faults.py").exists()
