"""Build, load and launch the port's hand-written CUDA kernels (csrc/).

The layer under both kernel modules: _flash_kernels.py (attention) and
_moe_kernels.py (the MoE FFN's routing and row copies) each declare the
C entry points of their sources here with ``declare`` when imported, and
launch them with ``launch``. Neither imports the other.

Build: ``nvcc`` compiles each source under ``csrc/``, all at once, into
its own shared library with a plain C interface under
``build/tpu_dra_torch/`` at the repository root (listed in .gitignore),
at first use. File names carry a hash of the sources and flags, so an
edit rebuilds. The libraries are loaded with ``ctypes``; every pointer
and the stream are ``c_void_p``, and every entry returns a CUDA error
code.

``launch`` calls an entry on a tensor's card with the current stream of
that card as its last argument, raises if the launch fails, and counts
it under the entry's name: ``launches()`` reads the counts of every
declared entry since the last ``reset_launches()``. There is no other
path: no fallback from a failed build or launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from tpu_dra_torch.native import gpuinfo

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_dra_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong

# {source stem: {C entry point: argtypes}} of every declared source.
ENTRY_POINTS: dict[str, dict[str, list]] = {}
_loaded: dict[str, ctypes.CDLL] = {}
_launches: dict[str, int] = {}


def declare(sources: dict[str, dict[str, list]]) -> None:
    """Declare {source stem: {C entry point: argtypes}} (the stream, last,
    included): the build compiles csrc/<stem>.cu, and launch() calls its
    entries."""
    for stem, entries in sources.items():
        ENTRY_POINTS[stem] = dict(entries)
        for entry in entries:
            _launches.setdefault(entry, 0)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every kernel source that has no library for the current
    sources yet, one nvcc per source, all started together. Returns
    {source stem: library path}; raises with the compilers' output if
    any source fails."""
    nvcc = gpuinfo.nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: BUILD_DIR / f"lib{src.stem}_{digest}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    log = []
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        log.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
        else:
            tmp.replace(lib)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return libs


def _lib(name: str) -> ctypes.CDLL:
    """The library that holds C entry point `name`: every library built,
    and each declared source's loaded, at the first call that needs it."""
    if name not in _loaded:
        libs = build()
        for stem, entries in ENTRY_POINTS.items():
            if entries.keys() & _loaded.keys():
                continue
            lib = ctypes.CDLL(str(libs[stem]))
            for entry, argtypes in entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _loaded[entry] = lib
    return _loaded[name]


def device_of(x: torch.Tensor, kind: str) -> str:
    """"cpu" (the caller runs its plain version) or "cuda"; any other
    device raises: no `kind` kernel runs there."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kind} kernel for device {x.device}")
    return x.device.type


def launch(entry: str, x: torch.Tensor, *args) -> None:
    """Call C entry point `entry` with `args` and the current stream of
    x's card, on that card; count it, and raise if the launch fails."""
    with torch.cuda.device(x.device):
        err = getattr(_lib(entry), entry)(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    _launches[entry] += 1


def reset_launches() -> None:
    for entry in _launches:
        _launches[entry] = 0


def launches() -> dict[str, int]:
    """Launches of each declared C entry point since the last
    reset_launches()."""
    return dict(_launches)
