"""Event-driven GPU health monitor (counterpart of
tpu_dra/tpuplugin/health.py).

Waits on the backend's health events (NVML's critical-XID and
double-bit-ECC event set on a real node) in a short-timeout loop, skips
the benign codes of the skip list (plus the operator's
ADDITIONAL_XIDS_TO_IGNORE) and hands every other event to the driver,
which republishes the ResourceSlice without the GPU. A "recovered"
record is never skipped: it re-admits the GPU.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Iterable, Optional, Set

from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.infra.trace import dump_flight_recorder
from tpu_dra_torch.native.gpuinfo import GpuInfoBackend, HealthEvent

log = logging.getLogger("tpu_dra_torch.gpuplugin.health")

# 1 while a monitor thread is wedged in the backend event wait (stop()
# timed out joining it): health events are NOT flowing and GPUs can die
# unnoticed until restart.
wedged_gauge = DefaultRegistry.gauge(
    "tpu_dra_health_monitor_wedged",
    "1 while the device health monitor thread is wedged in a backend "
    "wait that never returned (health events not flowing), 0 otherwise")

# Benign, application-level codes that must not yank a GPU (the
# reference's skip list, as it has it).
DEFAULT_SKIPPED_CODES = frozenset({13, 31, 43, 45, 68})

# Event kind signalling a previously-faulted GPU is serviceable again;
# the driver re-admits it to the inventory.
RECOVERED_KIND = "recovered"

# The wait quantum: short so stop() is responsive — the loop re-enters the
# wait at once, so event latency is unchanged.
WAIT_TIMEOUT_S = 0.5


class DeviceHealthMonitor:
    def __init__(self, backend: GpuInfoBackend,
                 on_unhealthy: Callable[[HealthEvent], None],
                 additional_codes_to_ignore: Optional[Iterable[int]] = None):
        self._backend = backend
        self._on_unhealthy = on_unhealthy
        self._skip: Set[int] = set(DEFAULT_SKIPPED_CODES)
        self._skip.update(additional_codes_to_ignore or [])
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # True when stop() timed out joining the monitor thread: the
        # thread is wedged (a backend wait that never returns) and health
        # events are no longer flowing.
        self.wedged = False

    def start(self) -> None:
        # A (re)started monitor clears the tripwire: the gauge reports
        # the CURRENT pipeline, not a predecessor a restart replaced.
        self.wedged = False
        wedged_gauge.set(0)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gpu-health-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=WAIT_TIMEOUT_S + 1)
            if self._thread.is_alive():
                self.wedged = True
                wedged_gauge.set(1)
                dump_path = dump_flight_recorder("wedged")
                log.error(
                    "health monitor thread did not stop within %.1fs — "
                    "wedged in the backend event wait; health events are "
                    "NOT flowing (GPUs can die unnoticed until restart); "
                    "flight recorder dumped to %s",
                    WAIT_TIMEOUT_S + 1, dump_path)

    def _run(self) -> None:
        while not self._stop.is_set():
            # Injection site: chaos schedules mint synthetic events
            # (arm with payload=HealthEvent(...)) without a backend that
            # can produce them on demand.
            event = (FAULTS.pull("health.chip_event")
                     or self._backend.wait_health_event(WAIT_TIMEOUT_S))
            if event is None:
                continue
            # Recovery records are never filtered by the skip list (a
            # swallowed recovery strands the GPU out of the inventory).
            if event.kind != RECOVERED_KIND and event.code in self._skip:
                continue
            self._on_unhealthy(event)
