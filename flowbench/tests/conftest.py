"""The benchmark's tests.  Tests that need a CUDA card take the `card`
fixture, which skips them where torch sees none: the decision is made when
the test runs, never while a module is imported."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest flowbench/tests -q -m card)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
