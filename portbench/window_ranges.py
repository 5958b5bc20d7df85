"""The port's range ``attention.window`` (mimo_model.hybrid_attention: a
window layer's attend call and its sink rescale) in a traced window, for
metrics/attention.window_ms_per_step.py and the hybrid attention's two
roofline shares (kernels.swa_attn_roofline, kernels.gqa_attn_roofline).

The ranges are found as ``named_ranges.from_events`` finds them, with
``attention.window`` as a layer range. One rule differs: the window
range holds ``attention.fwd`` (attend opens it inside), so the attention
Function's forward has attention.fwd as its innermost range, and
named_ranges links its backward there alone. Here a backward node is
linked to ``attention.window`` as well where its forward operation ran
while the window range was open on that thread, at any depth: the fused
backward and everything its node launches count as the window's. A run
from a port that opens no window range reads None.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

from portbench import frozen, named_ranges, ranges, trace

WINDOW = "attention.window"


def _window_links(cpu) -> List[ranges.Link]:
    """Backward nodes whose forward operation ran inside WINDOW, at any
    depth of the ranges open then, each linked to WINDOW."""
    held: Dict[int, list] = {}
    for e in cpu:
        if e.name == WINDOW:
            held.setdefault(e.thread, []).append(
                (float(e.time_range.start), float(e.time_range.end), WINDOW))
    inside = set()
    for e in cpu:
        if (e.sequence_nr < 0 or e.thread not in held
                or e.name.startswith(ranges.BACKWARD_NODE)):
            continue
        t = float(e.time_range.start)
        if any(a <= t <= b for a, b, _ in held[e.thread]):
            inside.add((e.thread, e.sequence_nr))
    return [(float(e.time_range.start), float(e.time_range.end), e.thread,
             WINDOW, e.name[len(ranges.BACKWARD_NODE):].lstrip(": "))
            for e in cpu
            if e.name.startswith(ranges.BACKWARD_NODE) and e.sequence_nr >= 0
            and (e.fwd_thread, e.sequence_nr) in inside]


def from_events(events, steps: int) -> Optional[ranges.ProgramTrace]:
    """named_ranges.from_events with WINDOW as a layer range and the
    window's links above added; None where the program opened no window
    range."""
    from torch.autograd import DeviceType

    program = named_ranges.from_events(events, steps, layers=(WINDOW,))
    if program is None:
        return None
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    return dataclasses.replace(
        program, links=sorted(program.links + _window_links(cpu)))


# id(run) -> [a weak reference to the run, its ProgramTrace]
_SEEN: Dict[int, list] = {}


def of(run: trace.TraceRun) -> Optional[ranges.ProgramTrace]:
    """The program's view of `run` with the window's links; None without
    a window range or without a live session."""
    held = _SEEN.get(id(run))
    if held is None or held[0]() is not run:
        for key in [k for k, v in _SEEN.items() if v[0]() is None]:
            del _SEEN[key]
        events = ranges.session_events(run)
        held = [weakref.ref(run),
                None if events is None else from_events(events, run.steps)]
        _SEEN[id(run)] = held
    return held[1]


def attention_ms(run: trace.TraceRun) -> Optional[Tuple[float, float]]:
    """(window, global): device ms per step of the attention kernels
    (frozen.ATTENTION: names holding "flash_") under WINDOW and its
    linked backward, and of those outside it; None without a window
    range."""
    program = of(run)
    if program is None:
        return None
    window = other = 0.0
    for op, (us, labels) in zip(program.launched, program._placed):
        if frozen.category(op[2]) != frozen.ATTENTION:
            continue
        if WINDOW in labels:
            window += us
        else:
            other += us
    return window / run.steps / 1e3, other / run.steps / 1e3
