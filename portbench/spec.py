"""Resolve a cell of BENCHMARK.json to the files that define it, by name.

Imports nothing heavy (no torch): ``__main__`` resolves the cell before a
driver imports what it needs.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path = ROOT

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_benchmark(path: Path = BENCHMARK) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` of root/BENCHMARK.json, its config,
    traffic and limits read from the files their names give, and the
    metrics that apply to it."""
    root = Path(root)
    package = root / PACKAGE.name
    bench = load_benchmark(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[entry["config"]]["file"])
    traffic = _read_json(package / "traffic" / f"{entry['traffic']}.json")
    limits_file = package / "limits" / f"{workload}.json"
    limits = _read_json(limits_file) if limits_file.exists() else {}
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)


def driver_module(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.driver}")


def model_module(cell: Cell):
    """The program side of the cell's model family (imports the port)."""
    return importlib.import_module(f"portbench.models.{cell.family}")


def reference_module(cell: Cell):
    """The plain reference of the cell's model family."""
    return importlib.import_module(f"portbench.reference.{cell.family}")


def metric_reader(name: str, root: Path = ROOT):
    """The `read(run)` of metrics/<name>.py, loaded by path (metric names
    hold dots, which an import name cannot)."""
    path = Path(root) / PACKAGE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
