"""Tests of the benchmark (``gsbench/``), run on the CPU at test sizes:

    python -m pytest gsbench/tests -q

Tests that need the card carry the ``card`` marker and skip without one
(the ``card`` fixture decides, never an import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: every cell at a size a test run holds
TINY = {"config": {"scene": {"n_gaussians": 3000},
                   "dataset": {"width": 96, "height": 64, "images": 12},
                   "render": {"max_pairs": 60000, "max_pairs_sorted": None}},
        "traffic": {"width": 96, "height": 64, "trace_steps": 2,
                    "trace_frames": 2}}
CELLS = ("bicycle-train", "lego-train", "bicycle-render-1080p",
         "lego-render-800")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
