"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the same
driver, families and reference, tiny widths and traffic, and limits of
its own size.

The cell's limits hold at the cell's size; at this size the program's
precision reads otherwise. LIMITS were set by the cell's rule (the
geometric mean of the largest sound reading and the least of the
control, where 3x that, and of the faults), rounded up to two
significant figures, from `portbench.calibrate`'s readings of
``cell(name)`` on the CPU: 12 sound seeds, 3 of the control and of each
fault, from its default base. Readings (lower / upper, upper's source):

- transformer_lm: loss 1.45e-4 / 2.36e-3 (half batch); grad1 2.47e-3 /
  1.45e-2 (control); change 2.52e-3 / 1.26e-2 (control); grad1 median
  1.10e-3 / 0.241 (half batch); change median 1.32e-3 / 4.21e-3 (control).
- moe_lm: loss 2.44e-4 / 1.20e-3 (control); grad1 8.03e-3 / 0.319 (half
  batch); change 5.57e-3 / 0.295 (half batch); grad1 median 1.64e-3 /
  0.0936 (half batch); change median 1.86e-3 / 0.0807 (half batch).
"""

import dataclasses

from portbench import spec

TINY = {"vocab": 256, "d_model": 64, "n_heads": 4, "n_layers": 2,
        "d_ff": 128}
LIMITS = {
    "transformer_lm": {"loss_gap": 5.9e-4, "grad1_gap": 6.0e-3,
                       "change_gap": 5.7e-3, "grad1_median_gap": 0.017,
                       "change_median_gap": 2.4e-3},
    "moe_lm": {"loss_gap": 5.5e-4, "grad1_gap": 0.051, "change_gap": 0.041,
               "grad1_median_gap": 0.013, "change_median_gap": 0.013},
}


def cell(name: str, **traffic):
    full = spec.resolve(name)
    tr = dict(full.traffic, batch=8, seq=128, pool=6)
    tr.update(traffic)
    return dataclasses.replace(
        full, config=dict(full.config, **TINY), traffic=tr,
        limits={"limits": dict(LIMITS[full.family])})
