"""What a traced window leaves for the per-layer readers.

The driver profiles a run of whole train steps with torch.profiler (CPU
and CUDA activity) and hands the readers a ``TraceRun``: the device's
operations, the host's operations on the stepping thread, the host
window the steps took and what the benchmark counts of their work. The
device's busy time is the union of its operations' intervals, so two
operations that overlap count once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from portbench import frozen

Span = Tuple[float, float, str]   # start us, end us, name
STEP_RANGE = "portbench.step"
TOP = 10


@dataclasses.dataclass
class TraceRun:
    kernels: List[Span]            # device operations, sorted by start
    host_ops: List[Span]           # host operations of the stepping thread
    window_s: float                # host clock over the traced steps
    steps: int
    tokens_per_step: int
    flops_per_token: float         # model FLOPs per trained token
    attention_calls: list          # (B, S, H, d) of each call in a step
    peak_mem_bytes: Optional[int]
    device_name: str

    @property
    def peaks(self) -> Optional[dict]:
        return frozen.PEAKS.get(self.device_name)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _ in self.kernels:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def category_ms_per_step(self, category: str) -> Optional[float]:
        """Device ms per step of the kernels in `category`
        (frozen.category), None where the trace holds none."""
        us = [end - start for start, end, name in self.kernels
              if frozen.category(name) == category]
        if not us:
            return None
        return sum(us) / self.steps / 1e3


def from_profile(events, **fields) -> TraceRun:
    """A TraceRun from torch.profiler's events of the traced window."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    step_threads = {e.thread for e in events if e.name == STEP_RANGE}
    for e in events:
        span = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type == DeviceType.CUDA:
            # The step's range is mirrored on the device's timeline; it
            # is no device operation.
            if e.name != STEP_RANGE:
                kernels.append(span)
        elif e.thread in step_threads:
            host.append(span)
    kernels.sort()
    host.sort()
    return TraceRun(kernels=kernels, host_ops=host, **fields)


def _host_op_at(host: List[Span], t: float) -> str:
    """The innermost host operation running at time t."""
    best = None
    for start, end, name in host:
        if start > t:
            break
        if end >= t and (best is None or start >= best[0]):
            best = (start, end, name)
    return best[2] if best else "no host operation"


def breakdown(run: TraceRun) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device operations, each named by the host operation
    running when the device went idle and the operation that ended the
    gap; the window's edges (from the first enqueue to the first
    operation, and from the last one to the host's synchronize) count as
    one gap."""
    by_name: dict = {}
    for start, end, name in run.kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    busy = run.busy_intervals()
    starts = [s for s, _, _ in run.kernels]
    names = [n for _, _, n in run.kernels]
    j = 0
    for (_, prev_end), (next_start, _) in zip(busy, busy[1:]):
        while starts[j] < next_start:
            j += 1
        gaps.append((prev_end, next_start, names[j]))
    longest = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:TOP]
    idle = [[f"{_host_op_at(run.host_ops, a)[:80]} -> {nxt[:80]}",
             (b - a) / 1e6] for a, b, nxt in longest]
    if busy:
        edges = run.window_s - (busy[-1][1] - busy[0][0]) / 1e6
        idle.append(["window edges: first enqueue, final synchronize",
                     edges])
        idle = sorted(idle, key=lambda g: -g[1])[:TOP]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": idle}
