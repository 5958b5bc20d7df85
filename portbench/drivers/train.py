"""Driver of a training cell: the port's train step, timed over a window.

One run, one process:

1. set-up: the weights and a pool of token batches are drawn from the
   seed on the device; the port's model and train step are built on the
   weights; the step runs its first steps (FIRST_STEPS) through the same
   call and feed as the window, on the pool's first batches, which warms
   every shape the window uses. The readings the check needs are taken
   here: each step's loss, the per-leaf norm of the first gradient
   ((p0 - p1) / lr, p0 drawn again from the seed) and of the change
   after the first steps.
2. the window: the same step object trains on the next batches of the
   pool, one call after another with no host synchronize, until
   ``--seconds`` have passed on the host clock; then one synchronize
   ends it. ``train_tokens_per_s`` is B x (S - 1) trained tokens per
   step, over every step of the window, over the window's wall time.
   With ``--trace 1`` torch.profiler records the window's first steps
   (about TRACE_TARGET_S of them), and the per-layer readers
   (metrics/<name>.py) read that trace.
3. after the window: the losses of the window's steps are read (a
   non-finite one is a failed step), the device's peak memory is read,
   the program is freed, and the plain reference trains from the same
   weights on the same first batches; ``checks`` compares the two.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

FIRST_STEPS = 3
TRACE_TARGET_S = 2.0
TRACE_MIN_STEPS = 3
TRACE_MAX_STEPS = 64
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_dra")


def process_elapsed() -> float:
    """Seconds since this process started (Linux /proc, 10 ms ticks)."""
    import os

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - started


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the
    benchmark must never load, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit(device):
    """The card's power limit as nvidia-smi prints it, or None."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip() or None


def setup(cell, seed: int, device, *, fault: str = None,
          marks: dict = None) -> dict:
    """Set-up of a run: the weights and the token pool from `seed`, the
    port's train step built on the weights, its first steps, and the
    program's readings for the check. `fault` plants one of the model
    module's FAULTS in the program (tests and calibration only); `marks`
    gets the process's age at the end of each phase."""
    marks = {} if marks is None else marks
    import torch

    from portbench import spec, weights
    from portbench import traffic as gen

    model_mod = spec.model_module(cell)
    cfg, tr = cell.config, cell.traffic
    lr = cfg["lr"]
    leaves = spec.reference_module(cell).leaves(cfg)
    flat, tree = weights.make(leaves, seed, device)
    pool = gen.batches(tr, cfg["vocab"], seed, device)
    _sync(device)
    marks["weights"] = process_elapsed()
    step = model_mod.build(cfg, tr, tree, fault=fault)
    marks["build"] = process_elapsed()
    losses = [step(pool[0])]
    _sync(device)
    marks["step1"] = process_elapsed()
    start, _ = weights.make(leaves, seed, device)
    grad1 = weights.leaf_norms(start, flat, leaves, 1.0 / lr)
    del start
    _sync(device)
    t = time.perf_counter()
    for i in range(1, FIRST_STEPS):
        losses.append(step(pool[i]))
    _sync(device)
    step_s = (time.perf_counter() - t) / (FIRST_STEPS - 1)
    start, _ = weights.make(leaves, seed, device)
    program = {"losses": [float(x) for x in losses], "grad1": grad1,
               "change": weights.leaf_norms(flat, start, leaves)}
    marks["steps"] = process_elapsed()
    return {"step": step, "pool": pool, "program": program, "step_s": step_s}


def reference_readings(cell, seed: int, pool, device,
                       precision: str = "fp32") -> dict:
    """The reference's readings over the run's first batches."""
    from portbench import spec
    from portbench.reference import sgd

    return sgd.readings(spec.reference_module(cell), cell.config, seed,
                        [pool[i] for i in range(FIRST_STEPS)],
                        cell.config["lr"], device, precision)


def run(cell, seed: int, seconds: float, trace: bool, device, *,
        fault: str = None, marks: dict = None) -> dict:
    """One run of a training cell on `device`; returns the result line's
    fields (``checks`` last). `fault` and `marks` as setup's."""
    marks = {} if marks is None else marks
    import torch

    from portbench import checks, spec
    from portbench import trace as tracing

    model_mod = spec.model_module(cell)
    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        torch.empty(1, device=device)
    marks["cuda"] = process_elapsed()
    state = setup(cell, seed, device, fault=fault, marks=marks)
    step, pool, program = state["step"], state["pool"], state["program"]
    step_s = state["step_s"]
    del state
    trace_steps = min(TRACE_MAX_STEPS,
                      max(TRACE_MIN_STEPS, math.ceil(TRACE_TARGET_S / step_s)))
    prof = traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()      # its start-up belongs to set-up
    gc.collect()
    _sync(device)

    # The window.
    window_losses = []
    n = 0
    setup_s = marks["window"] = process_elapsed()
    t0 = time.perf_counter()
    while True:
        batch = pool[(FIRST_STEPS + n) % pool.shape[0]]
        if prof is not None and traced is None:
            with record_function(tracing.STEP_RANGE):
                window_losses.append(step(batch))
        else:
            window_losses.append(step(batch))
        n += 1
        if prof is not None and traced is None and n == trace_steps:
            _sync(device)
            traced = (n, time.perf_counter() - t0)
            prof.stop()
        if time.perf_counter() - t0 >= seconds and (prof is None
                                                   or traced is not None):
            break
    _sync(device)
    window_s = time.perf_counter() - t0

    # After the window.
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    del step, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tokens_per_step = tr["batch"] * (tr["seq"] - 1)
    result = {"correct": None, "attempted": n, "failed": failed}
    if trace:
        run_ = tracing.from_profile(
            prof.events(), window_s=traced[1], steps=traced[0],
            tokens_per_step=tokens_per_step,
            flops_per_token=model_mod.flops_per_token(cfg, tr["seq"]),
            attention_calls=model_mod.attention_calls(cfg, tr["batch"],
                                                      tr["seq"]),
            peak_mem_bytes=peak,
            device_name=torch.cuda.get_device_name(device) if cuda else "cpu")
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(run_)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"train_tokens_per_s": n * tokens_per_step / window_s,
                    "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in measured}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        result["device"]["busy_s"] = run_.busy_s
        result["device"]["window_s"] = run_.window_s
        result["breakdown"] = tracing.breakdown(run_)
        del prof, run_

    nums = checks.numbers(program, reference_readings(cell, seed, pool, device))
    ok, rows = checks.judge(nums, cell.limits)
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    return result


def main(cell, args) -> int:
    marks = {"python": process_elapsed()}
    import torch

    marks["torch"] = process_elapsed()

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 marks=marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    limit = power_limit(device)
    result["device"]["power_limit"] = limit
    result["setup_marks_s"] = marks
    result["checks"] = result.pop("checks")     # the last key
    print("portbench: set-up, process age at the end of each phase (s): "
          + " ".join(f"{k} {v:.2f}" for k, v in marks.items()),
          file=sys.stderr)
    print(f"portbench: {cell.name} seed {args.seed} on "
          f"{result['device']['kind']} ({limit}): "
          f"correct={result['correct']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
