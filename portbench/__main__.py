"""``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell of BENCHMARK.json once and prints one JSON line last on
standard output. Imports no torch itself: the cell's driver imports what
it needs, after the cache directories below are fixed.
"""

from __future__ import annotations

import argparse
import os
import sys

from portbench import spec

# Every build and kernel cache, at fixed paths inside the checkout, so that
# only a checkout's first run builds. The port's own nvcc build goes to
# build/tpu_dra_torch/ of the checkout (_flash_kernels.BUILD_DIR).
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "build/portbench/triton",
    "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
    "CUDA_CACHE_PATH": "build/portbench/nv_compute_cache",
}
# One process with few host threads: the host only launches work.
THREAD_ENV = {"OMP_NUM_THREADS": "4", "MKL_NUM_THREADS": "4"}


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(spec.ROOT / rel)
    for key, value in THREAD_ENV.items():
        os.environ.setdefault(key, value)
    cell = spec.resolve(args.workload)
    return spec.driver_module(cell).main(cell, args)


if __name__ == "__main__":
    sys.exit(main())
