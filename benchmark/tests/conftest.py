"""Tests of the benchmark itself (the harness, its yardstick and its
reference), run on the CPU with small shapes; those marked ``gpu`` need the
card and skip without one. Run from the repository's root:

    python -m pytest benchmark/tests -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
