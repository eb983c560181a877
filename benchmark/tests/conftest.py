"""The benchmark's own tests: run from the repository's root with
``python -m pytest benchmark/tests -q``.  Card-only tests carry the ``gpu``
marker and skip without a CUDA card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
