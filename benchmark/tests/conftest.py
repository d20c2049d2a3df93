"""Tests of the benchmark's own code. Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked `gpu` need a CUDA card and skip without one (decided inside
the test, by the `cuda_card` fixture)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips (with a reason) without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    from harness.loader import Benchmark
    return Benchmark(ROOT)
