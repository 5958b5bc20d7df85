"""dralint for the port (counterpart of tpu_dra/analysis).

``python -m tpu_dra_torch.analysis`` lints ``tpu_dra_torch/``,
``tests/test_torch_*.py`` and ``chip_smoke.py`` against the concurrency
and ownership invariants the control plane depends on (R1-R8, R12; R9-R11
in raceanalysis, R13-R15 in flowanalysis), with the port's own fault-site,
metric and feature-gate registries under ``tpu_dra_torch/infra``. The
rules are the reference's, rule for rule; only the registry lookups in
``core`` name the port's paths. ``tests/test_torch_dralint.py`` makes a
zero-finding run a test gate. Whole-tree runs are
incremental via the per-file result cache (core.run(use_cache=True),
``--no-cache`` to disable). The dynamic complement — the drmc
deterministic model checker — lives in ``tpu_dra_torch.analysis.drmc``
(SURVEY §13).
"""

from tpu_dra_torch.analysis import rules as _rules  # noqa: F401 — registers R1-R8
from tpu_dra_torch.analysis import raceanalysis as _race  # noqa: F401 — R9-R11
from tpu_dra_torch.analysis import flowanalysis as _flow  # noqa: F401 — R13-R15
from tpu_dra_torch.analysis.core import (
    Finding, Module, ProjectContext, Report, Rule, all_rules, find_root,
    lint_source, lint_sources, render, run,
)

__all__ = [
    "Finding", "Module", "ProjectContext", "Report", "Rule",
    "all_rules", "find_root", "lint_source", "lint_sources", "render",
    "run",
]
