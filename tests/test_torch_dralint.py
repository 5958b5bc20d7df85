"""The port's dralint (tpu_dra_torch.analysis) against the reference's
(tpu_dra.analysis), and the port's whole-tree gate.

Analyzer parity: every fixture the reference's analysis tests
(tests/test_dralint.py, test_raceanalysis.py, test_flowanalysis.py) hand
to the analyzer is replayed through both packages, one parametrised case
per analyzer call, and the findings must be equal as
``(rule, path, line, col, message)``. The fixtures live in
``tests/torch_analysis_corpus.json``, recorded from those tests'
own calls by running this file as a script (``PYTHONPATH=. python
tests/test_torch_dralint.py`` from the repo root): ``lint_sources`` calls (with the rule ids
and the hand-built ProjectContext of each call), ``race_run`` trees (the
findings plus the static lock-order graph and the guarded-by table) and
``run`` calls over a tmp tree (replayed cold in a tmp root that holds the
recorded registry files under both ``tpu_dra/infra`` and
``tpu_dra_torch/infra``). The corpus carries the sha1 of the files it
was recorded from, so a changed reference test fails here until it is
recorded again. The R9-R11 and R13-R15 cases run in
test_torch_raceanalysis.py and test_torch_flowanalysis.py.

The port's gate: ``python -m tpu_dra_torch.analysis --require-justified``
over its default paths (tpu_dra_torch/, tests/test_torch_*.py,
chip_smoke.py) exits 0, and the reference's gate over its own default
paths (which take in these files) stays green too.
"""

import hashlib
import json
import os
import sys
from pathlib import Path

import pytest

import tpu_dra.analysis as ref_analysis
import tpu_dra.analysis.__main__ as ref_main
import tpu_dra_torch.analysis as port_analysis
import tpu_dra_torch.analysis.__main__ as port_main
from tpu_dra.analysis import raceanalysis as ref_race
from tpu_dra_torch.analysis import core as port_core
from tpu_dra_torch.analysis import raceanalysis as port_race

REPO = Path(__file__).resolve().parent.parent
CORPUS = Path(__file__).resolve().parent / "torch_analysis_corpus.json"
SOURCE_FILES = ("tests/test_dralint.py", "tests/test_raceanalysis.py",
                "tests/test_flowanalysis.py")
REGISTRY_NAMES = ("faults.py", "metrics.py", "featuregates.py")


def _sha1(rel: str) -> str:
    return hashlib.sha1((REPO / rel).read_bytes()).hexdigest()


def load_corpus():
    if not CORPUS.exists():     # before the first recording
        return {"sources": {}, "cases": []}
    return json.loads(CORPUS.read_text())


def corpus_cases(origin_file: str):
    """pytest params: the corpus's cases recorded from `origin_file`."""
    cases = [c for c in load_corpus()["cases"]
             if c["origin"].startswith(origin_file + "::")]
    return [pytest.param(c, id=f"{c['origin'].split('::', 1)[1]}#{c['n']}")
            for c in cases]


# ---------------------------------------------------------------------------
# Replay: one recorded analyzer call through both packages
# ---------------------------------------------------------------------------

def _ctx(pkg, doc):
    if doc is None:
        return None
    return pkg.ProjectContext(
        root=Path(doc["root"]), fault_sites=dict(doc["fault_sites"]),
        fault_degradations=dict(doc["fault_degradations"]),
        fault_sites_path=doc["fault_sites_path"],
        metric_catalog=dict(doc["metric_catalog"]),
        metric_catalog_path=doc["metric_catalog_path"],
        gate_names=set(doc["gate_names"]), scanned=set(doc["scanned"]))


def _key(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def _race_run(pkg, race_mod, sources):
    """The reference tests' race_run: the draracer rule alone over a
    fixture tree (rule state + unfiltered findings)."""
    core = pkg.core
    ctx = pkg.ProjectContext(root=Path("."))
    rule = race_mod.RaceAnalysis()
    findings = []
    for rel, src in sources.items():
        mod = core.parse_module(Path(rel), Path("."), source=src)
        assert mod is not None, rel
        findings.extend(rule.scan(mod, ctx))
    findings.extend(rule.finalize(ctx))
    return rule, findings


def _run_in_root(pkg, root: Path, case):
    report = pkg.core.run([root / p for p in case["paths"]], root=root,
                          rule_ids=(set(case["rule_ids"])
                                    if case["rule_ids"] else None),
                          use_cache=False, jobs=1)
    # The port reads its registries under tpu_dra_torch/infra: a finding
    # anchored there is the same finding as the reference's.
    def norm(findings):
        return [(f.rule, f.path.replace("tpu_dra_torch/infra/",
                                        "tpu_dra/infra/"),
                 f.line, f.col, f.message) for f in findings]
    return (norm(report.findings), norm(report.suppressed),
            norm(report.unjustified))


def replay(case, tmp_path):
    """(reference result, port result) for one corpus case."""
    kind = case["kind"]
    if kind == "sources":
        rule_ids = set(case["rule_ids"]) if case["rule_ids"] else None
        return tuple(
            _key(pkg.lint_sources(dict(case["sources"]),
                                  ctx=_ctx(pkg, case["ctx"]),
                                  rule_ids=rule_ids))
            for pkg in (ref_analysis, port_analysis))
    if kind == "race":
        out = []
        for pkg, race_mod in ((ref_analysis, ref_race),
                              (port_analysis, port_race)):
            rule, findings = _race_run(pkg, race_mod, case["sources"])
            out.append((_key(findings), sorted(rule.static_edges.items()),
                        race_mod.locks_report(rule)))
        return tuple(out)
    assert kind == "run", kind
    root = tmp_path / "root"
    for rel, text in case["files"].items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    for pkg_dir in ("tpu_dra", "tpu_dra_torch"):
        for name, text in case["registries"].items():
            p = root / pkg_dir / "infra" / name
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
    return tuple(_run_in_root(pkg, root, case)
                 for pkg in (ref_analysis, port_analysis))


# ---------------------------------------------------------------------------
# The corpus: fresh, and equal findings for every R1-R8/R12 fixture
# ---------------------------------------------------------------------------

class TestCorpus:
    def test_recorded_from_the_current_reference_tests(self):
        doc = load_corpus()
        assert doc["sources"] == {rel: _sha1(rel) for rel in SOURCE_FILES}

    def test_every_reference_file_and_kind_contributes(self):
        cases = load_corpus()["cases"]
        assert len(cases) >= 150
        origins = {c["origin"].split("::", 1)[0] for c in cases}
        assert origins == set(SOURCE_FILES)
        assert {c["kind"] for c in cases} == {"sources", "race", "run"}


@pytest.mark.parametrize("case", corpus_cases("tests/test_dralint.py"))
def test_parity(case, tmp_path):
    ref, port = replay(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# The port's gate (the tree scans of this file: two)
# ---------------------------------------------------------------------------

class TestPortGate:
    def test_whole_tree_green_with_require_justified(self, capsys):
        rc = port_main.main(["--root", str(REPO), "--no-cache",
                             "--require-justified", "--rule-table"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "0 findings" in out

    def test_default_paths_are_the_ports(self):
        paths = [p.relative_to(REPO).as_posix()
                 for p in port_core.default_paths(REPO)]
        assert paths[0] == "tpu_dra_torch"
        assert paths[-1] == "chip_smoke.py"
        assert "tests/test_torch_dralint.py" in paths
        assert not [p for p in paths if p.startswith("tests/")
                    and not p.startswith("tests/test_torch_")]

    def test_registries_parsed_from_the_ports_infra(self):
        ctx = port_analysis.ProjectContext.load(REPO)
        assert ctx.fault_sites_path == "tpu_dra_torch/infra/faults.py"
        assert ctx.metric_catalog_path == "tpu_dra_torch/infra/metrics.py"
        assert "health.chip_event" in ctx.fault_sites
        for name in ("tpu_dra_lint_findings_total",
                     "tpu_dra_lint_cache_hits_total",
                     "tpu_dra_drmc_schedules_total",
                     "tpu_dra_drmc_crashpoints_total"):
            assert name in ctx.metric_catalog
        assert "MultiprocessSupport" in ctx.gate_names
        assert port_core.find_root(REPO / "tpu_dra_torch" / "infra") == REPO

    def test_cache_file_is_the_ports_own(self):
        assert port_core.CACHE_FILENAME == ".dralint-torch-cache.json"
        assert ref_analysis.core.CACHE_FILENAME == ".dralint-cache.json"

    def test_reference_gate_still_green_over_its_tree(self, capsys):
        rc = ref_main.main(["--root", str(REPO), "--no-cache",
                            "--require-justified"])
        out = capsys.readouterr().out
        assert rc == 0, out

    def test_missing_path_is_a_usage_error(self, tmp_path, capsys):
        rc = port_main.main([str(tmp_path / "nope.py")])
        assert rc == 2


class TestSeededFindings:
    """The registry-bound rules read the port's registries: a fixture
    tree with a port registry under tpu_dra_torch/infra fires R4/R5/R6
    on its entries, and a tree with only the reference's does not
    become a port root."""

    @staticmethod
    def _tree(tmp_path, pkg_dir="tpu_dra_torch"):
        infra = tmp_path / pkg_dir / "infra"
        infra.mkdir(parents=True)
        (infra / "faults.py").write_text('SITES = {"a.b": "x"}\n')
        (infra / "metrics.py").write_text(
            'METRICS_CATALOG = {"tpu_dra_known_total": "m"}\n')
        (infra / "featuregates.py").write_text('GateA = "GateA"\n')
        return tmp_path

    def test_registry_rules_read_the_ports_files(self, tmp_path):
        root = self._tree(tmp_path)
        (root / "mod.py").write_text(
            'FAULTS.check("a.typo")\n'
            'C = DefaultRegistry.counter("tpu_dra_new_total")\n'
            'featuregates.enabled("GateTypo")\n')
        report = port_core.run([root], root=root, use_cache=False)
        msgs = [(f.rule, f.message) for f in report.findings]
        assert any(r == "R4" and "'a.typo'" in m for r, m in msgs)
        assert any(r == "R4" and "'a.b' has no production guard" in m
                   for r, m in msgs)
        assert any(r == "R5" and "tpu_dra_new_total" in m
                   for r, m in msgs)
        assert ("R6", "unknown feature gate 'GateTypo'") in msgs

    def test_reference_registries_do_not_make_a_port_root(self, tmp_path):
        root = self._tree(tmp_path, pkg_dir="tpu_dra")
        ctx = port_analysis.ProjectContext.load(root)
        assert ctx.fault_sites == {} and ctx.metric_catalog == {}
        assert port_core.find_root(root / "tpu_dra") != root

    def test_warm_cached_run_equals_cold(self, tmp_path):
        root = self._tree(tmp_path)
        (root / "mod.py").write_text(
            "import threading\nimport time\n"
            "class M:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def f(self):\n"
            "        with self._lock:\n"
            "            time.sleep(1)\n")
        cold = port_core.run([root / "mod.py"], root=root, use_cache=True)
        assert (root / ".dralint-torch-cache.json").exists()
        assert not (root / ".dralint-cache.json").exists()
        warm = port_core.run([root / "mod.py"], root=root, use_cache=True)
        assert warm.cache_hits == 1 and cold.cache_hits == 0
        assert _key(warm.findings) == _key(cold.findings)
        assert [f.rule for f in cold.findings] == ["R2"]

    def test_jobs_parity(self, tmp_path):
        """A --jobs pool scan reports what a serial scan reports, per-file
        rules and the whole-tree lock-order rule alike, and its cold run
        primes a cache that a warm serial run hits on every file."""
        root = self._tree(tmp_path)
        pkg = root / "pkg"
        pkg.mkdir()
        for i in range(4):
            (pkg / f"m{i}.py").write_text(
                "import threading\nimport time\n"
                f"class M{i}:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n"
                "    def f(self):\n"
                "        with self._lock:\n"
                f"            time.sleep({i + 1})\n")
        (pkg / "order.py").write_text(
            "import threading\n"
            "A = threading.Lock()\n"
            "B = threading.Lock()\n"
            "def ab():\n"
            "    with A:\n"
            "        with B:\n"
            "            pass\n"
            "def ba():\n"
            "    with B:\n"
            "        with A:\n"
            "            pass\n")

        def key(report):
            return (_key(report.findings), _key(report.suppressed),
                    _key(report.unjustified))

        serial = port_core.run([pkg], root=root)
        parallel = port_core.run([pkg], root=root, jobs=2)
        assert key(serial) == key(parallel)
        assert "<scan-pool>" in parallel.timings
        assert sorted({f.rule for f in serial.findings}) == ["R11", "R2"]
        cold = port_core.run([pkg], root=root, use_cache=True, jobs=2)
        warm = port_core.run([pkg], root=root, use_cache=True)
        assert warm.cache_hits == warm.files == 5
        assert key(cold) == key(warm) == key(serial)


# ---------------------------------------------------------------------------
# Recording the corpus (run this file as a script)
# ---------------------------------------------------------------------------

class _Recorder:
    """A pytest plugin that records the reference analyzer's calls made
    by the reference's analysis tests (module docstring)."""

    def __init__(self):
        from tpu_dra.analysis import core

        self.cases = []
        self._n = {}
        self._core = core
        real_lint, real_run = core.lint_sources, core.run

        def lint_sources(sources, ctx=None, rule_ids=None):
            self._add({"kind": "sources", "sources": dict(sources),
                       "rule_ids": sorted(rule_ids) if rule_ids else None,
                       "ctx": self._ctx_doc(ctx)})
            return real_lint(sources, ctx=ctx, rule_ids=rule_ids)

        def run(paths, root=None, rules=None, rule_ids=None,
                use_cache=False, jobs=1):
            self._add_run(paths, root, rule_ids)
            return real_run(paths, root=root, rules=rules,
                            rule_ids=rule_ids, use_cache=use_cache,
                            jobs=jobs)

        core.lint_sources = ref_analysis.lint_sources = lint_sources
        core.run = ref_analysis.run = run

    @staticmethod
    def _origin():
        return os.environ.get("PYTEST_CURRENT_TEST", "").rsplit(" ", 1)[0]

    def _add(self, case):
        origin = self._origin()
        if not origin.startswith(SOURCE_FILES):
            return
        n = self._n.get(origin, 0)
        self._n[origin] = n + 1
        self.cases.append({"origin": origin, "n": n, **case})

    @staticmethod
    def _ctx_doc(ctx):
        if ctx is None:
            return None
        return {"root": str(ctx.root), "fault_sites": ctx.fault_sites,
                "fault_degradations": ctx.fault_degradations,
                "fault_sites_path": ctx.fault_sites_path,
                "metric_catalog": ctx.metric_catalog,
                "metric_catalog_path": ctx.metric_catalog_path,
                "gate_names": sorted(ctx.gate_names),
                "scanned": sorted(ctx.scanned)}

    def _add_run(self, paths, root, rule_ids):
        paths = [Path(p) for p in paths]
        root = Path(root) if root else self._core.find_root(paths[0])
        if root.resolve() == REPO:
            return  # a run over the real tree is the whole-tree gates' job
        files = {p.relative_to(root).as_posix(): p.read_text()
                 for p in self._core.iter_python_files(paths)
                 if "tpu_dra/infra" not in p.relative_to(root).as_posix()}
        registries = {name: (root / "tpu_dra" / "infra" / name).read_text()
                      for name in REGISTRY_NAMES
                      if (root / "tpu_dra" / "infra" / name).exists()}
        self._add({"kind": "run", "files": files, "registries": registries,
                   "paths": [p.relative_to(root).as_posix() for p in paths],
                   "rule_ids": sorted(rule_ids) if rule_ids else None})

    def pytest_collection_finish(self, session):
        mod = sys.modules.get("test_raceanalysis")
        if mod is None:
            return
        real = mod.race_run

        def race_run(sources):
            import textwrap

            self._add({"kind": "race",
                       "sources": {rel: textwrap.dedent(src)
                                   for rel, src in sources.items()}})
            return real(sources)

        mod.race_run = race_run


def record() -> int:
    rec = _Recorder()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                      *SOURCE_FILES], plugins=[rec])
    if rc != 0:
        return int(rc)
    doc = {"sources": {rel: _sha1(rel) for rel in SOURCE_FILES},
           "cases": rec.cases}
    CORPUS.write_text(json.dumps(doc, indent=0, sort_keys=True) + "\n")
    print(f"{len(rec.cases)} cases -> {CORPUS}")
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(record())
