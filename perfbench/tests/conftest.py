"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, tiny CPU versions of the cells, and the card's fixture."""

import sys
from pathlib import Path

import pytest
import torch

# the tiny runs are many small torch calls: one thread each under xdist
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, never
    while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)
