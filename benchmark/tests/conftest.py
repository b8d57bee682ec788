"""The benchmark's tests: the harness, its yardstick and its reference on
the CPU at small sizes; the ``gpu``-marked tests run one short cell on the
card and skip without one."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    """Skips the test on a machine without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")
