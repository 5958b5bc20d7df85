"""Every cell of BENCHMARK.json resolves by name to the files that define
it, and a new cell resolves from new files alone."""

import json
import shutil

import pytest

from portbench import checks, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    assert spec.driver_module(cell).main
    assert spec.model_module(cell).build
    assert spec.reference_module(cell).leaves(cell.config)
    assert set(cell.limits["limits"]) == set(checks.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_new_cell_from_new_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, limits and metric reader
    resolve from files added beside the others and an entry added to
    BENCHMARK.json; no existing file changes."""
    shutil.copytree(spec.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    pkg = tmp_path / "portbench"
    (pkg / "configs" / "tiny_lm.json").write_text(json.dumps(
        {"family": "transformer_lm", "vocab": 256, "d_model": 64,
         "n_heads": 4, "n_layers": 2, "d_ff": 128, "lr": 1e-3,
         "reduced": []}))
    (pkg / "traffic" / "s64.json").write_text(json.dumps(
        {"driver": "train", "batch": 2, "seq": 64, "token_law": "uniform",
         "pool": 4}))
    (pkg / "limits" / "tiny_lm.s64.json").write_text(json.dumps(
        {"limits": {name: 1 for name in checks.NUMBERS}}))
    (pkg / "metrics" / "host.steps.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench["configs"].append({"name": "tiny_lm", "source": "x",
                             "file": "portbench/configs/tiny_lm.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_lm.s64", "config": "tiny_lm",
                               "traffic": "s64", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host.steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "host", "moves": "setup_s",
                               "workloads": ["tiny_lm.s64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("tiny_lm.s64", root=tmp_path)
    assert cell.config["d_model"] == 64 and cell.traffic["seq"] == 64
    assert cell.limits["limits"]["loss_gap"] == 1
    assert [m["name"] for m in cell.per_layer] == ["host.steps"]
    assert spec.metric_reader("host.steps", tmp_path)(
        type("Run", (), {"steps": 3})) == 3.0
    assert spec.driver_module(cell).main and spec.model_module(cell).build
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    # The cells already there are untouched by the new entry.
    assert spec.resolve(CELLS[0], root=tmp_path).config == \
        spec.resolve(CELLS[0]).config


def test_limits_that_leave_a_number_out_fail():
    """A cell cannot drop a compared number: every one is judged."""
    nums = {name: 0.0 for name in checks.NUMBERS}
    full = {"limits": {name: 1.0 for name in checks.NUMBERS}}
    assert checks.judge(nums, full)[0] is True
    for name in checks.NUMBERS:
        partial = {"limits": {k: v for k, v in full["limits"].items()
                              if k != name}}
        ok, rows = checks.judge(nums, partial)
        assert ok is False and (name, 0.0, None) in rows
