"""The port's own ranges and counters in a traced window, for the
per-layer readers that split device time by the program's phases and
layers.

The port opens named ranges inside its train step while a profiler
session records (``tpu_dra_torch.infra.trace.device_span``, names in
PROGRAM_RANGES here and DEVICE_SPANS there) and counts the MoE router's
work then (``read_counters``). A reader is handed the driver's
``trace.TraceRun``, which holds neither, so ``of(run)`` goes back to the
torch.profiler session the run was made from: the live session whose
events ``trace.from_profile`` turns into that very run. From its events
it places each device operation under the program's ranges:

- A device operation is under every program range that was open, on any
  thread, when the host call that launched it started: the CUDA runtime
  or driver call that shares its correlation id (the event id the
  profiler gives both), on that call's thread. One whose call the trace
  lacks is under no range. The stepping thread waits inside
  ``step.backward`` while autograd's thread launches the backward, so
  the phases hold across threads; the innermost range open is the one it
  belongs to, and a reader of a range counts the ranges inside it.
- Autograd generates the backward of a layer range (LINKED: every
  program range outside the step's phases). A backward node
  (``autograd::engine::evaluate_function: ...``) whose sequence number
  and forward thread are those of a forward operation inside layer range
  R (the innermost open on that operation's thread) is linked to R, and
  what it launches is under R as well. ``attention.bwd`` is a range of
  its own.
- A reader's time under a range is the sum of its operations' device
  times, as ``TraceRun.category_ms_per_step``'s is, per traced step.

A run made from a port without the ranges, or with no live session to
go back to, has no ProgramTrace (None), and its readers return None.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

from portbench import trace

Range = Tuple[float, float, str, int]   # start us, end us, name, thread
# A device operation: start us, end us, name, and its launching host
# call's start us and thread (None, None where the trace has none).
Launched = Tuple[float, float, str, Optional[float], Optional[int]]
# A backward node linked to a layer range: start us, end us, thread,
# the range's name, the node's name.
Link = Tuple[float, float, int, str, str]

# The port's ranges (tpu_dra_torch/infra/trace.py: DEVICE_SPANS), copied
# so that a checkout without them reads as one that opens none.
PHASES = ("step.forward", "step.backward", "step.sgd")
LINKED = ("attention.fwd", "moe.route", "moe.dispatch", "moe.experts",
          "moe.combine")
PROGRAM_RANGES = ("step",) + PHASES + ("attention.bwd",) + LINKED
BACKWARD_NODE = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class ProgramTrace:
    ranges: List[Range]            # the program's ranges on every thread
    launched: List[Launched]       # every device operation, by start
    links: List[Link]              # backward nodes linked to layer ranges
    steps: int

    def under(self) -> List[Tuple[float, frozenset]]:
        """(device us, the ranges it is under) of each launched device
        operation: the program ranges open at its launch and the layer
        ranges of the backward nodes open then."""
        times = [t for *_, t, _ in self.launched]
        intervals = ([(a, b, name) for a, b, name, _ in self.ranges]
                     + [(a, b, name) for a, b, _, name, _ in self.links])
        opened = open_at(intervals, times)
        return [(end - start, frozenset(label for _, _, label in now))
                for (start, end, *_), now in zip(self.launched, opened)]

    @functools.cached_property
    def _placed(self) -> List[Tuple[float, frozenset]]:
        return self.under()

    def range_ms_per_step(self, *names: str) -> Optional[float]:
        """Device ms per step of the operations under any of `names`,
        None where none is."""
        want = set(names)
        us = [d for d, labels in self._placed if labels & want]
        if not us:
            return None
        return sum(us) / self.steps / 1e3


def open_at(intervals: Iterable[Tuple[float, float, str]],
            times: List[Optional[float]]) -> List[list]:
    """For each time, the intervals (start, end, label) that hold it,
    start included and end included; none for a time of None."""
    ordered = sorted(intervals)
    out: List[list] = [[] for _ in times]
    active: list = []
    i = 0
    for k in sorted((k for k, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        t = times[k]
        while i < len(ordered) and ordered[i][0] <= t:
            active.append(ordered[i])
            i += 1
        active = [iv for iv in active if iv[1] >= t]
        out[k] = list(active)
    return out


def _links(cpu) -> List[Link]:
    """The backward nodes whose forward operation ran inside a layer
    range (LINKED), each with that range."""
    by_thread: Dict[int, list] = {}
    for e in cpu:
        if e.name in LINKED:
            by_thread.setdefault(e.thread, []).append(
                (float(e.time_range.start), float(e.time_range.end), e.name))
    forward = [e for e in cpu if e.sequence_nr >= 0
               and not e.name.startswith(BACKWARD_NODE)
               and e.thread in by_thread]
    owner: Dict[Tuple[int, int], str] = {}
    for thread, ranges in by_thread.items():
        ops = [e for e in forward if e.thread == thread]
        opened = open_at(ranges, [float(e.time_range.start) for e in ops])
        for e, now in zip(ops, opened):
            if now:   # the innermost: the latest to open
                owner[(thread, e.sequence_nr)] = max(now)[2]
    links = []
    for e in cpu:
        if e.name.startswith(BACKWARD_NODE) and e.sequence_nr >= 0:
            name = owner.get((e.fwd_thread, e.sequence_nr))
            if name is not None:
                links.append((float(e.time_range.start),
                              float(e.time_range.end), e.thread, name,
                              e.name[len(BACKWARD_NODE):].lstrip(": ")))
    return sorted(links)


def from_events(events, steps: int) -> Optional[ProgramTrace]:
    """The program's view of torch.profiler's events of `steps` traced
    steps, None where the program opened none of its ranges."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = sorted((float(e.time_range.start), float(e.time_range.end),
                     e.name, e.thread) for e in cpu
                    if e.name in PROGRAM_RANGES)
    if not ranges:
        return None
    calls = {e.id: e for e in cpu if e.name.startswith("cu")}
    launched = []
    for e in events:
        # Device operations as trace.from_profile lists them; a range
        # mirrored on the device's timeline is none.
        if (e.device_type != DeviceType.CUDA or e.name == trace.STEP_RANGE
                or e.name in PROGRAM_RANGES):
            continue
        call = calls.get(e.id)
        launched.append((float(e.time_range.start), float(e.time_range.end),
                         e.name)
                        + ((None, None) if call is None else
                           (float(call.time_range.start), call.thread)))
    launched.sort(key=lambda op: op[:3])
    return ProgramTrace(ranges=ranges, launched=launched, links=_links(cpu),
                        steps=steps)


def session_events(run: trace.TraceRun):
    """The events of the live torch.profiler session that `run` was
    made from (``trace.from_profile`` of them, with the run's own other
    fields, equals the run), or None where no live session does."""
    import torch.profiler

    fields = {f.name: getattr(run, f.name)
              for f in dataclasses.fields(trace.TraceRun)
              if f.name not in ("kernels", "host_ops")}
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.profiler.profile):
            continue
        if getattr(obj.profiler, "kineto_results", None) is None:
            continue   # not started, or still recording
        try:
            events = obj.events()
        except (AssertionError, RuntimeError):
            continue
        if trace.from_profile(events, **fields) == run:
            return events
    return None


# id(run) -> [a weak reference to the run, its ProgramTrace, its counters]
_SEEN: Dict[int, list] = {}


def _entry(run: trace.TraceRun) -> list:
    held = _SEEN.get(id(run))
    if held is None or held[0]() is not run:
        held = [weakref.ref(run), dataclasses.MISSING, dataclasses.MISSING]
        _SEEN[id(run)] = held
        for key in [k for k, v in _SEEN.items() if v[0]() is None]:
            del _SEEN[key]
    return held


def remember(run: trace.TraceRun, program: Optional[ProgramTrace] = None,
             counters: Optional[dict] = None) -> None:
    """Give `run` its program view and counters directly, as a run made
    without a live session (a synthetic trace) has them."""
    held = _entry(run)
    held[1] = program
    held[2] = dict(counters or {})


def of(run: trace.TraceRun) -> Optional[ProgramTrace]:
    """The program's ranges and each device operation's launch in the
    session `run` was made from; None without ranges or a session."""
    held = _entry(run)
    if held[1] is dataclasses.MISSING:
        events = session_events(run)
        held[1] = None if events is None else from_events(events, run.steps)
    return held[1]


def range_ms_per_step(run: trace.TraceRun, *names: str) -> Optional[float]:
    """Device ms per step under any of the program ranges `names`, by the
    rule above; None where the run has none of them."""
    program = of(run)
    return None if program is None else program.range_ms_per_step(*names)


def counters(run: trace.TraceRun) -> Dict[str, float]:
    """The port's counters over `run`'s traced steps (they count only
    while a profiler session records; read once per run, which resets
    them in the port), or {} from a port that has none."""
    held = _entry(run)
    if held[2] is dataclasses.MISSING:
        try:
            from tpu_dra_torch.infra.trace import read_counters
        except ImportError:
            held[2] = {}
        else:
            held[2] = read_counters()
    return held[2]
