"""All-reduce bandwidth probe over a process group (counterpart of
tpu_dra/workloads/allreduce.py).

An all-reduce across every rank of the group, timed, reported as
*algorithm bandwidth* (payload bytes / time) and *bus bandwidth* (scaled
by 2(n-1)/n, the ring all-reduce traffic factor, so numbers compare
across device counts and with NCCL's own reporting). On a claim's GPUs
this measures the NVLink path the claim allocated. ``local_hbm_bandwidth``
is the one-device stand-in: a chain of in-place scales over a buffer.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
import torch.distributed as dist

from tpu_dra_torch.workloads import _dist


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def local_hbm_bandwidth(nbytes: int = 64 << 20, iters: int = 1000,
                        warmup: int = 2, reps: int = 3,
                        device="cuda") -> Dict[str, float]:
    """One device's memory-bandwidth proxy: a chain of `iters` scales of
    an `nbytes` bf16 buffer, u <- u * (1 + eps * u[i]), each step one
    launch that reads the buffer once and writes it once
    (``torch.addcmul(u, u, u[i], value=eps, out=w)``, u and w swapping
    roles: the scale is read from the buffer, which no launch may write
    while reading it), reported as (read + write bytes) / time per
    step.

    The scale reads the buffer (u[i]), so no step can be folded into
    another; two-point timing (1 and 1 + `iters` steps, each run ending
    in a device synchronize, min over `reps`) cancels the per-run
    overhead."""
    device = torch.device(device)
    elems = max(1, nbytes // 2)
    bufs = [torch.ones(elems, dtype=torch.bfloat16, device=device)
            for _ in range(2)]
    eps = 1e-8

    def run(k: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        for i in range(k):
            u, w = bufs[i % 2], bufs[1 - i % 2]
            torch.addcmul(u, u, u[i % elems], value=eps, out=w)
        _sync(device)
        return time.perf_counter() - t0

    for _ in range(max(1, warmup)):
        run(1)
        run(1 + iters)
    t_small = min(run(1) for _ in range(reps))
    t_big = min(run(1 + iters) for _ in range(reps))
    mean_s = max((t_big - t_small) / iters, 1e-9)
    size = bufs[0].element_size() * elems
    return {"hbm_proxy_gbps": 2 * size / mean_s / 1e9,  # a read + a write
            "payload_mib": size / (1 << 20),
            "mean_s": mean_s}


def allreduce_bandwidth(nbytes_per_device: int = 64 << 20, iters: int = 10,
                        warmup: int = 3, group=None,
                        device=None) -> Dict[str, float]:
    """Time the all-reduce of one bf16 buffer of `nbytes_per_device` per
    rank over `group` (the default group when None and one is up), on
    this rank's `device`.

    Returns {algo_gbps, bus_gbps, n_devices, payload_mib, mean_s}. Over
    one rank there is no collective (XLA compiles the reference's away):
    both rates are exactly 0.0 and nothing is timed. Each all-reduce
    consumes the previous one's output, prescaled by 1/n so the values
    stay ~1.0; each timed run ends in a device synchronize, and two-point
    timing (1 and 1 + `iters` all-reduces) cancels its overhead."""
    if group is None and _dist.is_up():
        group = dist.group.WORLD
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return {"algo_gbps": 0.0, "bus_gbps": 0.0, "n_devices": 1.0,
                "payload_mib": nbytes_per_device / (1 << 20), "mean_s": 0.0}
    device = torch.device(device or "cpu")
    elems = max(1, nbytes_per_device // 2)
    x = torch.ones(elems, dtype=torch.bfloat16, device=device)
    inv_n = 1.0 / n

    def run(k: int) -> float:
        _dist.barrier(device)
        t0 = time.perf_counter()
        for _ in range(k):
            x.mul_(inv_n)
            dist.all_reduce(x, group=group)
        _sync(device)
        return time.perf_counter() - t0

    for _ in range(max(1, warmup)):
        run(1)
    t_small, t_big = run(1), run(1 + iters)
    mean_s = max((t_big - t_small) / iters, 1e-9)
    payload = x.element_size() * elems
    algo_gbps = payload / mean_s / 1e9
    return {"algo_gbps": algo_gbps,
            "bus_gbps": algo_gbps * (2 * (n - 1) / n),
            "n_devices": float(n),
            "payload_mib": payload / (1 << 20),
            "mean_s": mean_s}
