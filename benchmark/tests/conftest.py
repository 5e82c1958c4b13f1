"""Shared pieces of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests -q``). A test that needs the card
is marked ``cuda`` and decides about the card in the ``card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    return torch.device("cuda")


@pytest.fixture
def tiny_cfg():
    import json

    with open(TINY) as f:
        return json.load(f)
