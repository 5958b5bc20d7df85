"""The embedding witness at a tiny size on the CPU: the port's float32
path and the bf16 path's upstream gradient summed in fp32 both agree with
the reference, so a gap of the bf16 path's own sum is its accumulation."""

import pytest
import torch

from portbench import embed_witness
from portbench.tests import tiny


def test_witness_separates_the_accumulation():
    cell = tiny.cell("flagship.s1k_uniform", token_law="zipf")
    row = embed_witness.witness(cell.config, cell.traffic, 21,
                                torch.device("cpu"))
    assert row["program_fp32"] == pytest.approx(row["reference"], rel=1e-4)
    assert row["upstream_fp32_sum"] == pytest.approx(row["reference"],
                                                     rel=2e-2)
    assert row["top_id_count"] > 100
    assert 0 < row["top_row_ratio"] <= 1.01
