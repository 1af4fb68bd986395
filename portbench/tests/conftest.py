"""The card fixture of the benchmark's ``cuda`` tests: whether there is a
card is decided inside the fixture, never at import."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
