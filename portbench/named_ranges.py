"""The attribution rule of ``portbench/ranges.py`` over layer ranges the
caller names, for readers of ranges that ``ranges.PROGRAM_RANGES`` does
not list (the DeepSeek-V3 family's ``mla.project`` and ``moe.shared``).

``ranges.py`` holds a fixed copy of the port's range names, so a range a
later program adds reads there as none. Here a reader gives the layer
ranges it reads (``LAYERS``), and each is treated as ranges.py treats
its LINKED ranges: a device operation is under every program range
(ranges.PROGRAM_RANGES and the named layers) open, on any thread, when
its launching host call started; a backward node whose sequence number
and forward thread are those of a forward operation inside a layer range
(the innermost open on that operation's thread, among ranges.LINKED and
the named layers) is linked to it, and what it launches counts there as
well. It goes back to the live profiler session with
``ranges.session_events``, finds what is open with ``ranges.open_at``
and sums with ``ranges.ProgramTrace``; a run from a port that opens none
of the named ranges reads None.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Sequence, Tuple

from portbench import ranges, trace

# The layer ranges this module's readers name.
LAYERS = ("mla.project", "moe.shared")


def _links(cpu, linked: Sequence[str]):
    """ranges._links with the layer ranges `linked`."""
    by_thread: Dict[int, list] = {}
    for e in cpu:
        if e.name in linked:
            by_thread.setdefault(e.thread, []).append(
                (float(e.time_range.start), float(e.time_range.end), e.name))
    forward = [e for e in cpu if e.sequence_nr >= 0
               and not e.name.startswith(ranges.BACKWARD_NODE)
               and e.thread in by_thread]
    owner: Dict[Tuple[int, int], str] = {}
    for thread, held in by_thread.items():
        ops = [e for e in forward if e.thread == thread]
        opened = ranges.open_at(held, [float(e.time_range.start) for e in ops])
        for e, now in zip(ops, opened):
            if now:   # the innermost: the latest to open
                owner[(thread, e.sequence_nr)] = max(now)[2]
    links = []
    for e in cpu:
        if e.name.startswith(ranges.BACKWARD_NODE) and e.sequence_nr >= 0:
            name = owner.get((e.fwd_thread, e.sequence_nr))
            if name is not None:
                links.append((float(e.time_range.start),
                              float(e.time_range.end), e.thread, name,
                              e.name[len(ranges.BACKWARD_NODE):].lstrip(": ")))
    return sorted(links)


def from_events(events, steps: int,
                layers: Sequence[str] = LAYERS) -> Optional[ranges.ProgramTrace]:
    """ranges.from_events with the layer ranges `layers` added to the
    program's and to the linked ones; None where the program opened none
    of `layers`."""
    from torch.autograd import DeviceType

    names = set(ranges.PROGRAM_RANGES) | set(layers)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((float(e.time_range.start), float(e.time_range.end),
                    e.name, e.thread) for e in cpu if e.name in names)
    if not any(name in layers for _, _, name, _ in spans):
        return None
    calls = {e.id: e for e in cpu if e.name.startswith("cu")}
    launched = []
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == trace.STEP_RANGE
                or e.name in names):
            continue
        call = calls.get(e.id)
        launched.append((float(e.time_range.start), float(e.time_range.end),
                         e.name)
                        + ((None, None) if call is None else
                           (float(call.time_range.start), call.thread)))
    launched.sort(key=lambda op: op[:3])
    return ranges.ProgramTrace(
        ranges=spans, launched=launched,
        links=_links(cpu, tuple(ranges.LINKED) + tuple(layers)), steps=steps)


# id(run) -> [a weak reference to the run, its ProgramTrace]
_SEEN: Dict[int, list] = {}


def of(run: trace.TraceRun) -> Optional[ranges.ProgramTrace]:
    """The program's view of `run` with LAYERS as layer ranges; None
    without them or without a live session."""
    held = _SEEN.get(id(run))
    if held is None or held[0]() is not run:
        for key in [k for k, v in _SEEN.items() if v[0]() is None]:
            del _SEEN[key]
        events = ranges.session_events(run)
        held = [weakref.ref(run),
                None if events is None else from_events(events, run.steps)]
        _SEEN[id(run)] = held
    return held[1]


def range_ms_per_step(run: trace.TraceRun, *names: str) -> Optional[float]:
    """Device ms per step under any of the ranges `names` (of LAYERS),
    their linked backward included; None where the run has none."""
    program = of(run)
    return None if program is None else program.range_ms_per_step(*names)

