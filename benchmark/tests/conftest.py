"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes).

    python -m pytest benchmark/tests -q

A tiny cell keeps a configuration's and a traffic mix's shapes of data but
few gaussians, views and pixels, so the program's plain CPU path and the
reference run in seconds.
"""

from __future__ import annotations

import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402

CELLS = ("bicycle-train-late", "dtu-field", "bicycle-render")


def tiny_cell(name: str, gaussians: int = 300, views: int = 3, width: int = 64,
              height: int = 48) -> harness.Cell:
    cell = copy.deepcopy(harness.cell(name))
    cell.config["gaussians"] = gaussians
    cell.config["cameras"].update(count=views, width=width, height=height)
    cell.traffic["check_points"] = 500
    return cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
