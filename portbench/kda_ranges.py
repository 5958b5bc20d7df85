"""The port's range ``attention.kda`` (kda.kda: a KDA layer from its input
projections' outputs through the gated RMSNorm) in a traced window, for
metrics/attention.kda_ms_per_step.py.

The ranges are found as ``named_ranges.from_events`` finds them, with
``attention.kda`` as a layer range. As in window_ranges.py, a backward
node is linked to ``attention.kda`` wherever its forward operation ran
while the KDA range was open on that thread, at any depth: the chunk
kernels' backward and everything its node launches count as the KDA
layer's. A run from a port that opens no KDA range reads None.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

from portbench import named_ranges, ranges, trace

KDA = "attention.kda"


def _kda_links(cpu) -> List[ranges.Link]:
    """Backward nodes whose forward operation ran inside KDA, at any depth
    of the ranges open then, each linked to KDA."""
    held: Dict[int, list] = {}
    for e in cpu:
        if e.name == KDA:
            held.setdefault(e.thread, []).append(
                (float(e.time_range.start), float(e.time_range.end)))
    inside = set()
    for e in cpu:
        if (e.sequence_nr < 0 or e.thread not in held
                or e.name.startswith(ranges.BACKWARD_NODE)):
            continue
        t = float(e.time_range.start)
        if any(a <= t <= b for a, b in held[e.thread]):
            inside.add((e.thread, e.sequence_nr))
    return [(float(e.time_range.start), float(e.time_range.end), e.thread,
             KDA, e.name[len(ranges.BACKWARD_NODE):].lstrip(": "))
            for e in cpu
            if e.name.startswith(ranges.BACKWARD_NODE) and e.sequence_nr >= 0
            and (e.fwd_thread, e.sequence_nr) in inside]


def from_events(events, steps: int) -> Optional[ranges.ProgramTrace]:
    """named_ranges.from_events with KDA as a layer range and the KDA
    links above added; None where the program opened no KDA range."""
    from torch.autograd import DeviceType

    program = named_ranges.from_events(events, steps, layers=(KDA,))
    if program is None:
        return None
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    return dataclasses.replace(
        program, links=sorted(set(program.links) | set(_kda_links(cpu))))


# id(run) -> [a weak reference to the run, its ProgramTrace]
_SEEN: Dict[int, list] = {}


def of(run: trace.TraceRun) -> Optional[ranges.ProgramTrace]:
    """The program's view of `run` with the KDA links; None without a
    KDA range or without a live session."""
    held = _SEEN.get(id(run))
    if held is None or held[0]() is not run:
        for key in [k for k, v in _SEEN.items() if v[0]() is None]:
            del _SEEN[key]
        events = ranges.session_events(run)
        held = [weakref.ref(run),
                None if events is None else from_events(events, run.steps)]
        _SEEN[id(run)] = held
    return held[1]
