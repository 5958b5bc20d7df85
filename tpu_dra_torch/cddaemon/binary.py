"""The domain daemon's native binary, built at first use.

``build()`` compiles tpu_dra_torch/native/src/domain_daemon.cc with the
host's ``c++`` into build/tpu_dra_torch/ and returns the binary's path.
The binary's name carries a hash of the source and the flags, so a
changed source builds anew and an unchanged one is built once; the build
runs under a file lock, so several processes that need the binary at
once (parallel test workers) compile it once. A build that fails raises
with the compiler's output.

``build(tsan=True)`` builds the ThreadSanitizer flavour beside it
(``TSAN_FLAGS``, the reference's ``native/Makefile`` TSANFLAGS), which
the race tier (tpu_dra_torch.race) drives.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

SOURCE = (Path(__file__).resolve().parents[1] / "native" / "src"
          / "domain_daemon.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_dra_torch"
CXX_FLAGS = ("-std=c++17", "-O2", "-pthread")
TSAN_FLAGS = ("-std=c++17", "-O1", "-g", "-fsanitize=thread", "-pthread")
BINARY = "gpu-domain-daemon"


def binary_path(tsan: bool = False) -> Path:
    """Where the binary of the current source lives once built."""
    flags, name = (TSAN_FLAGS, f"{BINARY}-tsan") if tsan else (
        CXX_FLAGS, BINARY)
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"


def _compilers() -> List[str]:
    """``$CXX`` first, then the C++ compilers on PATH: a host's ``$CXX``
    may lack a runtime that another of its compilers has (the card's
    host wraps its ``g++`` in one that finds no TSan runtime)."""
    found: List[str] = []
    for cxx in (os.environ.get("CXX"), shutil.which("c++"),
                shutil.which("g++"), shutil.which("clang++")):
        if cxx and cxx not in found:
            found.append(cxx)
    return found


def build(tsan: bool = False) -> str:
    """The path of the daemon built from the current source, compiling
    it first if no process has yet; ``tsan`` for the ThreadSanitizer
    flavour. Each compiler of ``_compilers()`` is tried in turn."""
    path = binary_path(tsan)
    if path.exists():
        return str(path)
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("no C++ compiler: set CXX or put c++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{BINARY}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        failures = []
        for cxx in compilers:
            if path.exists():
                break
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            try:
                proc = subprocess.run(
                    [cxx, *(TSAN_FLAGS if tsan else CXX_FLAGS), "-o",
                     str(tmp), str(SOURCE)],
                    capture_output=True, text=True, timeout=300)
            except OSError as e:
                failures.append(f"{cxx}: {e}")
                continue
            if proc.returncode == 0:
                tmp.replace(path)
                break
            tmp.unlink(missing_ok=True)
            failures.append(f"{cxx} (exit {proc.returncode}):\n"
                            f"{proc.stdout}{proc.stderr}")
        else:
            raise RuntimeError(f"{SOURCE.name} failed to build with "
                               + "\n".join(failures))
    return str(path)
