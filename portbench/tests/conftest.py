"""Tests of the benchmark. Run them from the repository root:

    python -m pytest portbench/tests -q              # here, on the CPU
    python -m pytest portbench/tests -q -m card      # on the card

A test that needs the card carries the ``card`` marker and asks for the
``cuda_device`` fixture, which decides whether a card is present (never
at import) and skips where there is none.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    import torch

    torch.set_num_threads(2)
