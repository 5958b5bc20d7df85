"""The traffic generator repeats for a seed and draws Zipf's law."""

import math

import torch

from portbench import traffic

TR = {"batch": 4, "seq": 64, "pool": 8, "token_law": "zipf", "zipf_s": 1.0}


def test_same_seed_same_batches():
    big = 2 ** 31 + 12_345
    a = traffic.batches(TR, 1000, big, "cpu")
    b = traffic.batches(TR, 1000, big, "cpu")
    assert a.shape == (8, 4, 64) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert not torch.equal(a, traffic.batches(TR, 1000, big + 1, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    traffic.batches(TR, 1000, 2 ** 63 + 5, "cpu")   # past 64 signed bits


def test_rows_all_differ():
    pool = traffic.batches(TR, 32768, 7, "cpu")
    rows = pool.reshape(-1, 64)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_zipf_law():
    probs = traffic.token_probs(32768, "zipf", 1.0)
    harmonic = sum(1.0 / k for k in range(1, 32769))
    assert float(probs[0]) == pytest_approx(1 / harmonic)
    assert float(probs[0] / probs[9]) == pytest_approx(10.0)
    ids = traffic.batches(dict(TR, batch=64, seq=1024), 32768, 3, "cpu")
    share0 = float((ids == 0).double().mean())
    assert abs(share0 - 1 / harmonic) < 0.01
    uniform = traffic.token_probs(100, "uniform")
    assert math.isclose(float(uniform.sum()), 1.0, rel_tol=1e-6)


def pytest_approx(x):
    import pytest

    return pytest.approx(x, rel=1e-5)
