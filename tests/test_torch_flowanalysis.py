"""The port's drflow (tpu_dra_torch.analysis.flowanalysis, R13-R15)
against the reference's, and the port's view-shadow cross-check.

- parity: every analyzer call of the reference's
  tests/test_flowanalysis.py, replayed through both packages from
  tests/torch_analysis_corpus.json (test_torch_dralint.py says how it is
  recorded), equal findings;
- the view shadow's export reader (``k8s.informer.load_drifts``) and
  ``check_view_shadow``'s classification, as the reference's tests hold
  them;
- the port's tree (one scan): the seeded scheduler chaos walk
  (``run_sched_schedule(11, 40)``) with the view shadow exporting, then
  every observed drift mapped to an R13-implicated view site
  (observed ⊆ static), and R13-R15 clean.
"""

import json

import pytest
import torch

from test_torch_dralint import REPO, corpus_cases, replay
from tpu_dra_torch.analysis import core as port_core
from tpu_dra_torch.analysis.flowanalysis import (
    FlowAnalysis, check_view_shadow,
)
from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.k8s import informer as informer_mod

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


@pytest.mark.parametrize("case", corpus_cases("tests/test_flowanalysis.py"))
def test_parity(case, tmp_path):
    ref, port = replay(case, tmp_path)
    assert port == ref


class TestLoadDrifts:
    def test_round_trip_through_the_export(self, tmp_path):
        path = tmp_path / "drifts.json"
        shadow = informer_mod.ViewShadow()
        prev = shadow.enable()
        try:
            assert shadow.export(str(path)) == str(path)
        finally:
            shadow.restore(prev)
        assert informer_mod.load_drifts(str(path)) == []
        path.write_text(json.dumps({"drifts": [
            {"site": "a.py:1", "key": "a"}]}))
        assert informer_mod.load_drifts(str(path)) == [
            {"site": "a.py:1", "key": "a"}]

    def test_missing_or_garbled_export_raises(self, tmp_path):
        with pytest.raises(OSError):
            informer_mod.load_drifts(str(tmp_path / "nope.json"))
        bad = tmp_path / "bad.json"
        bad.write_text("[]")
        with pytest.raises(ValueError):
            informer_mod.load_drifts(str(bad))

    def test_check_view_shadow_classification(self):
        rule = FlowAnalysis()
        rule.view_sites_recognized = {"a.py:1", "a.py:2"}
        rule.view_sites_implicated = {"a.py:1"}
        problems = check_view_shadow(rule, [
            {"site": "a.py:1", "key": "explained"},
            {"site": "a.py:2", "key": "missed"},
            {"site": "b.py:9", "key": "blind"},
        ])
        assert len(problems) == 2
        assert any("under-approximates" in p for p in problems)
        assert any("unknown to the static analyzer" in p for p in problems)


class TestPortTree:
    def test_view_shadow_walk_within_static_and_r13_r15_clean(
            self, tmp_path, monkeypatch):
        from tpu_dra_torch.simcluster.chaos import run_sched_schedule

        drifts_path = tmp_path / "drifts.json"
        monkeypatch.setenv(informer_mod.ViewShadow.EXPORT_ENV,
                           str(drifts_path))
        walk = run_sched_schedule(11, 40)
        assert walk.ok, walk.violations
        monkeypatch.delenv(informer_mod.ViewShadow.EXPORT_ENV)
        drifts = informer_mod.load_drifts(str(drifts_path))

        active = port_core.all_rules()
        report = port_core.run(port_core.default_paths(REPO), root=REPO,
                               rules=active, use_cache=False)
        flow = [f for f in report.findings
                if f.rule in ("R13", "R14", "R15")]
        assert flow == [], [f.format() for f in flow]
        rule = next(r for r in active if isinstance(r, FlowAnalysis))
        assert len(rule.view_sites_recognized) > 0
        assert check_view_shadow(rule, drifts) == []
        assert drifts == []
