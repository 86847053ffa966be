"""The benchmark's tests: the repository root, the benchmark's folder and
this one on the import path; ``card`` skips a test without a CUDA card."""

import os
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH)
for path in (TESTS, BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
