"""The check fails what it must: each fault a training cell can have,
planted in the timed path underneath a whole run (the harness's look for
a chip skipped), and the control (the reference computed in fp8, put in
the program's place), at a size a test run holds and against limits set
for that size (``tiny.LIMITS``). The last test runs the cell as it is
timed, on the card, against the cell's own limits."""

import pytest
import torch

from portbench import checks, spec
from portbench.drivers import train
from portbench.tests import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["flagship.s1k_uniform", "moe_lm.s1k_uniform"])
def test_fault_in_the_timed_path_is_not_correct(name, fault):
    cell = tiny.cell(name)
    result = train.run(cell, 2 ** 33 + 1, 0.2, False, torch.device("cpu"),
                       fault=fault)
    assert result["correct"] is False
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert any(row["value"] > row["limit"]
               for row in result["checks"].values())


@pytest.mark.parametrize("name", ["flagship.s1k_uniform", "moe_lm.s1k_uniform"])
def test_sound_run_is_correct(name):
    cell = tiny.cell(name)
    result = train.run(cell, 2 ** 35 + 3, 0.2, False, torch.device("cpu"))
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits(name):
    cell = tiny.cell(name)
    device = torch.device("cpu")
    state = train.setup(cell, 2 ** 34 + 9, device)
    pool = state["pool"]
    del state
    ref = train.reference_readings(cell, 2 ** 34 + 9, pool, device)
    control = train.reference_readings(cell, 2 ** 34 + 9, pool, device,
                                       precision="fp8")
    ok, rows = checks.judge(checks.numbers(control, ref), cell.limits)
    assert not ok, rows


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    cell = spec.resolve(name)
    result = train.run(cell, 2 ** 36 + 17, 3.0, True, cuda_device)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
    assert {"model.mfu", "kernels.attn_roofline"} <= set(result["metrics"])
