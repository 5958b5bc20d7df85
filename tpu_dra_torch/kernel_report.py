#!/usr/bin/env python3
"""Resource usage and times of one tree's flash-attention kernels.

    python3 tpu_dra_torch/kernel_report.py [--root DIR] [--label NAME]

Builds the kernels of the tree at DIR (default: the repository holding
this file) with that tree's own build code, and prints one JSON line:

- ``resources``: for every D=128 kernel instance, the registers, stack
  frame and local-memory bytes per thread (local memory holds register
  spills), as ``cuobjdump --dump-resource-usage`` reads them from the
  built library;
- ``ms``: each kernel's CUDA-event time (median of 5 windows of 10
  calls) at the flagship shape, B8 S1023 H16 D128 bf16, causal, rope,
  q/k/v views of one fused projection (the forward also without rope,
  ``flash_fwd_no_rope``, to show what the rotation costs); at the
  long_ctx_xl shape, B1 S16384 H16 D128 bf16 (windows of 3 calls); and
  at B1 S8192 H2 D128 fp32 where the tree's kernels take fp32.

To compare two trees on one card, unpack the other into a directory
that .gitignore lists and run this script on each in turn (A, B, B, A):
each run is its own process and builds into its own tree. Needs a CUDA
card and the CUDA toolkit (nvcc and cuobjdump side by side); uses only
the wrappers' public signatures, which every tree of the port shares.
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


def kernel_times(fk, rope_operands, b, s, h, d, dtype, inner=10) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    dlse = torch.zeros((b, h, s), device="cuda")
    tables = rope_operands(s, d, dtype, torch.device("cuda"))
    o, lse = fk.fwd(q, k, v, tables, causal=True)
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, dlse, tables)
    ms = {
        "flash_fwd": time_ms(lambda: fk.fwd(q, k, v, tables, causal=True),
                             inner=inner),
        # The same forward without the fused rotation: what RoPE costs.
        "flash_fwd_no_rope": time_ms(
            lambda: fk.fwd(q, k, v, None, causal=True), inner=inner),
        "flash_bwd_dq": time_ms(lambda: fk.bwd_dq(*args, causal=True),
                                inner=inner),
        "flash_bwd_dkv": time_ms(lambda: fk.bwd_dkv(*args, causal=True),
                                 inner=inner),
    }
    del q, k, v, dout, o, lse, delta, args, qkv
    torch.cuda.empty_cache()
    return ms


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

    nvcc = gpuinfo.nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    libs = fk.build()
    report = {
        "label": opts.label or str(root), "card": gpuinfo.nvidia_smi(),
        "resources": {name: resources(lib, cuobjdump)
                      for name, lib in sorted(libs.items())},
        "ms": {"bf16_b8_s1023_h16_d128": kernel_times(
            fk, _rope_operands, 8, 1023, 16, 128, torch.bfloat16),
               "bf16_b1_s16384_h16_d128": kernel_times(
            fk, _rope_operands, 1, 16384, 16, 128, torch.bfloat16, inner=3)},
    }
    if torch.float32 in getattr(fk, "KERNEL_DTYPES", {}):
        report["ms"]["fp32_b1_s8192_h2_d128"] = kernel_times(
            fk, _rope_operands, 1, 8192, 2, 128, torch.float32)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
