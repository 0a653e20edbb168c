"""The benchmark's own tests: `python3 -m pytest benchmark/tests -n0`.

Tests that need a CUDA card carry the `cuda` marker and decide inside
the test whether there is one; here they skip."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
