"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest mapbench/tests -q                  # here, on the CPU
    python -m pytest mapbench/tests -q -m cuda          # on a CUDA card

They import nothing of JAX or of the JAX package."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA card, decided when a test asks for it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "the card only")
    return "cuda"
