"""Fixtures of the benchmark's tests."""

import pytest


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
