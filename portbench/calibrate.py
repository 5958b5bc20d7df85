"""Readings the limits of a cell's check are set from, at the cell's size.

    python3 -m portbench.calibrate --workload flagship.s1k_uniform --seeds 12 \
        --control-seeds 3 [--out calibrate_flagship.s1k_uniform.json]

In one process, for each of `--seeds` seeds (drawn from `--base`): the
program's sound readings through the same set-up as a run's
(``drivers.train.setup``), against the fp32 reference. For the first
`--control-seeds` of them also the control (the reference computed in
fp8, ``reference/precision.py``, put in the program's place) and each
planted fault of the program (``FAULTS`` of the model module: a step that
leaves its state unchanged, the mean over half the batch) against the
same reference. Prints one JSON line per reading and a summary: per
compared number, the largest sound reading (the lower end of its limit)
and the smallest reading of the control and of each fault.

``--traffic <name>`` reads the cell's model under another mix of
``traffic/`` (a cell not in BENCHMARK.json, for a witness); ``--base N
--seeds 1`` re-reads the one seed N.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

from portbench import __main__ as entry
from portbench import spec, weights


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base", type=int, default=3_000_000_019)
    p.add_argument("--traffic", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of the script, not a reading")
    args = p.parse_args(argv)
    for key, rel in entry.CACHE_DIRS.items():
        os.environ[key] = str(spec.ROOT / rel)

    import torch

    from portbench import checks
    from portbench.drivers import train

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    if args.traffic:
        with open(spec.PACKAGE / "traffic" / f"{args.traffic}.json") as f:
            cell = dataclasses.replace(cell, traffic=json.load(f))
    faults = spec.model_module(cell).FAULTS
    rows = []
    for k in range(args.seeds):
        seed = args.base + 7_654_321 * k
        t = time.perf_counter()
        state = train.setup(cell, seed, device)
        program, pool = state["program"], state["pool"]
        del state
        _free(device)
        ref = train.reference_readings(cell, seed, pool, device)
        kinds = [("program", program)]
        if k < args.control_seeds:
            kinds.append(("control", train.reference_readings(
                cell, seed, pool, device, precision="fp8")))
            for fault in faults:
                state = train.setup(cell, seed, device, fault=fault)
                kinds.append((f"fault.{fault}", state["program"]))
                del state
                _free(device)
        names = [weights.leaf_name(path)
                 for path, _, _ in spec.reference_module(cell).leaves(cell.config)]
        for kind, readings in kinds:
            report = checks.leaf_report(readings, ref, names)
            row = {"workload": cell.name, "traffic": args.traffic,
                   "seed": seed, "kind": kind,
                   **checks.numbers(readings, ref), **report,
                   "losses": readings["losses"],
                   "ref_losses": ref["losses"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"calibrate: seed {seed} in {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    summary = {"workload": cell.name, "traffic": args.traffic, "device": (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")}
    for name in checks.NUMBERS:
        sound = [r[name] for r in rows if r["kind"] == "program"]
        summary[name] = {"lower": max(sound), "sound_median": sorted(sound)[len(sound) // 2]}
        for kind in sorted({r["kind"] for r in rows} - {"program"}):
            summary[name][kind] = min(r[name] for r in rows if r["kind"] == kind)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
