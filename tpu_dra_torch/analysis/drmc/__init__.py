"""drmc: deterministic interleaving + crash-point model checker.

Two engines over one controlled-scheduler substrate (SURVEY §13):

- ``explore``/``sched`` — real threads gated at the concurrency
  primitives' instrumentation points, DPOR-lite systematic exploration
  of their interleavings, byte-for-byte schedule replay;
- ``crash`` — a recording VFS behind ``infra.vfs`` that enumerates a
  simulated SIGKILL after every durable op (plus torn / all-persisted
  variants) and drives recovery invariants.

``python -m tpu_dra_torch.analysis.drmc`` is the gate (``chip_smoke.py``'s
``analysis`` phase runs it).
"""

from tpu_dra_torch.analysis.drmc.crash import (     # noqa: F401
    CrashPoint, CrashReport, RecordingVfs, enumerate_crashes,
)
from tpu_dra_torch.analysis.drmc.explore import (   # noqa: F401
    ExploreReport, replay, run_schedule,
)
from tpu_dra_torch.analysis.drmc.sched import (     # noqa: F401
    CooperativeScheduler, RunResult,
)
from tpu_dra_torch.analysis.drmc.scenarios import (  # noqa: F401
    CRASH_SCENARIOS, GATE_SCENARIOS, INTERLEAVING_SCENARIOS,
)
# NOTE: the `explore` attribute of this package is the SUBMODULE (its
# namesake function would shadow it); call drmc.explore.explore(...).
