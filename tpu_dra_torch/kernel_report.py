#!/usr/bin/env python3
"""Resource usage and times of one tree's flash-attention kernels.

    python3 tpu_dra_torch/kernel_report.py [--root DIR] [--label NAME]

Builds the kernels of the tree at DIR (default: the repository holding
this file) with that tree's own build code, and prints one JSON line:

- ``resources``: for every D=128 kernel instance, the registers, stack
  frame and local-memory bytes per thread (local memory holds register
  spills), as ``cuobjdump --dump-resource-usage`` reads them from the
  built library;
- ``ms``: CUDA-event times (median of 5 windows of 10 calls) of the
  forward and of the backward, first at the fp32 shapes where the tree's
  kernels take fp32 (B1 S8192 H2 D128, then the reference's
  streaming-tier test shape B2 S384 H2 D16; in trees before the fused
  fp32 backward its dkv kernel's times swing between processes, so fp32
  runs before any other shape's allocations), then at the flagship
  shape, B8 S1023 H16 D128 bf16, causal, rope, q/k/v views of one fused
  projection, and at the long_ctx_xl shape, B1 S16384 H16 D128 bf16
  (windows of 3 calls). The backward (``flash_bwd``) is one timed call
  of the tree's ``bwd`` wrapper, whichever kernels its route launches,
  so trees before and after a backward's redesign read the same work.
  Both directions are also timed without rope (``flash_fwd_no_rope``,
  ``flash_bwd_no_rope``) to show what the rotation costs;
- at the Moonlight cell's attention shape (B6 S8191 H16 bf16, causal):
  the forward and the backward at (q.k, v) = (192, 128), without rope,
  in trees whose kernels take split head dims (``SM90_SPLIT_HEAD_DIMS``),
  and, beside them, (128, 128) (``bf16_b6_s8191_h16_d192_v128``,
  ``..._d128_v128``; windows of 3 calls);
- ``device_ms``: the same calls' device time (torch.profiler: the
  kernels and fills they run, summed, per call). Where a shape is
  launch-bound (D=16) the CUDA-event window also holds the host's gaps
  between calls; this reading does not.

To compare two trees on one card, unpack the other into a directory
that .gitignore lists and run this script on each in turn (A, B, B, A):
each run is its own process and builds into its own tree. Needs a CUDA
card and the CUDA toolkit (nvcc and cuobjdump side by side); uses only
the wrappers' public signatures, which every tree of the port shares,
and the tree's ``build`` (``_cuda.build``, or ``_flash_kernels.build`` in
trees before that module).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path


def resources(lib: Path, cuobjdump: str) -> dict:
    """{function: {"REG": n, "STACK": n, "LOCAL": n}} of the D=128
    instances in `lib`."""
    text = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out = {}
    for name, fields in re.findall(r"Function (\S+):\s*\n\s*([^\n]+)", text):
        if "Li128E" not in name:
            continue
        vals = dict(re.findall(r"(\w+):(\d+)", fields))
        out[name] = {key: int(vals[key]) for key in ("REG", "STACK", "LOCAL")
                     if key in vals}
    if not out:
        raise RuntimeError(f"no D=128 kernel in cuobjdump's output for {lib}")
    return out


def time_ms(fn, reps=5, inner=10) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls=20) -> float:
    """Device time per call of fn: the durations of the CUDA kernels
    and fills that `calls` calls run, summed, over calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / calls


def kernel_times(fk, rope_operands, b, s, h, d, dtype, inner=10,
                 dv=None) -> tuple:
    """({name: CUDA-event ms}, {name: device ms}) of the forward and the
    backward, with and without rope, at q, k [b, s, h, d] and v [b, s, h,
    dv] (d by default); without rope only where dv differs from d (the
    kernels rotate in-tile at one head dim only)."""
    import torch

    dv = dv or d
    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((b, s, h * (2 * d + dv)), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(b, s, h, -1)
               for t in qkv.split([h * d, h * d, h * dv], dim=-1))
    dout = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
    dlse = torch.zeros((b, h, s), device="cuda")
    tables = (rope_operands(s, d, dtype, torch.device("cuda")) if dv == d
              else None)
    def backward(tables):
        o, lse = fk.fwd(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous(), dlse, tables)
        return lambda: fk.bwd(*args, causal=True)

    calls = {
        "flash_fwd": lambda: fk.fwd(q, k, v, tables, causal=True),
        # The same forward without the rotation: what RoPE costs.
        "flash_fwd_no_rope": lambda: fk.fwd(q, k, v, None, causal=True),
        "flash_bwd": backward(tables),
        "flash_bwd_no_rope": backward(None),
    }
    if tables is None:
        del calls["flash_fwd"], calls["flash_bwd"]
    ms = {name: time_ms(fn, inner=inner) for name, fn in calls.items()}
    dev = {name: device_ms(fn) for name, fn in calls.items()}
    del q, k, v, dout, qkv, calls
    torch.cuda.empty_cache()
    return ms, dev


# name: (B, S, H, D, Dv, dtype name, calls per timed window), in the
# order timed. The last two are the Moonlight cell's attention: a shape
# with Dv != D runs only in trees whose kernels take split head dims
# (SM90_SPLIT_HEAD_DIMS).
SHAPES = {
    "fp32_b1_s8192_h2_d128": (1, 8192, 2, 128, 128, "float32", 10),
    "fp32_b2_s384_h2_d16": (2, 384, 2, 16, 16, "float32", 10),
    "bf16_b8_s1023_h16_d128": (8, 1023, 16, 128, 128, "bfloat16", 10),
    "bf16_b1_s16384_h16_d128": (1, 16384, 16, 128, 128, "bfloat16", 3),
    "bf16_b6_s8191_h16_d192_v128": (6, 8191, 16, 192, 128, "bfloat16", 3),
    "bf16_b6_s8191_h16_d128_v128": (6, 8191, 16, 128, 128, "bfloat16", 3),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument("--label", default=None)
    opts = parser.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_report: no CUDA device", file=sys.stderr)
        return 1
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.workloads import _flash_kernels as fk
    from tpu_dra_torch.workloads.flashattention import _rope_operands

    try:   # the kernel layer both kernel modules sit on
        from tpu_dra_torch.workloads import _cuda as layer
    except ImportError:   # trees where _flash_kernels builds every source
        layer = fk
    nvcc = gpuinfo.nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    libs = layer.build()
    # The libraries of the kernels the timed wrappers route to; in trees
    # without routes every library is a flash kernel's.
    timed = ({*getattr(fk, "FWD_KERNELS", {}).values(),
              *getattr(fk, "BWD_KERNELS", {}).values()} or set(libs))
    report = {
        "label": opts.label or str(root), "card": gpuinfo.nvidia_smi(),
        "resources": {name: resources(lib, cuobjdump)
                      for name, lib in sorted(libs.items()) if name in timed},
        "ms": {}, "device_ms": {},
    }
    for name, (b, s, h, d, dv, dtype, inner) in SHAPES.items():
        dtype = getattr(torch, dtype)
        if dtype in getattr(fk, "KERNEL_DTYPES", {torch.bfloat16: 2}) and (
                dv == d or (d, dv) in getattr(fk, "SM90_SPLIT_HEAD_DIMS", ())):
            report["ms"][name], report["device_ms"][name] = kernel_times(
                fk, _rope_operands, b, s, h, d, dtype, inner=inner, dv=dv)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
