"""The domain daemon's native binary, built at first use.

``build()`` compiles tpu_dra_torch/native/src/domain_daemon.cc with the
host's ``c++`` into build/tpu_dra_torch/ and returns the binary's path.
The binary's name carries a hash of the source and the flags, so a
changed source builds anew and an unchanged one is built once; the build
runs under a file lock, so several processes that need the binary at
once (parallel test workers) compile it once. A build that fails raises
with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = (Path(__file__).resolve().parents[1] / "native" / "src"
          / "domain_daemon.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_dra_torch"
CXX_FLAGS = ("-std=c++17", "-O2", "-pthread")
BINARY = "gpu-domain-daemon"


def binary_path() -> Path:
    """Where the binary of the current source lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{BINARY}-{h.hexdigest()[:16]}"


def build() -> str:
    """The path of the daemon built from the current source, compiling
    it first if no process has yet."""
    path = binary_path()
    if path.exists():
        return str(path)
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put c++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{BINARY}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{cxx} failed to build {SOURCE.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            tmp.replace(path)
    return str(path)
