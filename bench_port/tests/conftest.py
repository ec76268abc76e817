"""Tests of the benchmark's harness: ``python -m pytest bench_port/tests``.

The tests marked ``card`` need a CUDA card and skip without one; the
others run on the CPU at toy sizes (``fixtures/``).  Nothing here imports
JAX.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tiny import make_here  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture
def tiny_here(tmp_path):
    return make_here(tmp_path / "bench")
