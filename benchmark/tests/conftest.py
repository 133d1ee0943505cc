"""Shared pieces of the benchmark's tests: the harness on the path, and
small configurations that a CPU test run holds."""

import sys
from pathlib import Path

import pytest
import torch

# the tests run in several workers: one thread each
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(size: int = 12):
    """A configuration override: the cell's own options on a small grid,
    2 x 2 x 2 boxes, overlap 1."""

    def small(cfg):
        cfg = dict(cfg)
        cfg["field"] = dict(cfg["field"], size=size)
        cfg["decomposition"] = {"boxes": [2, 2, 2], "overlap": 1}
        return cfg

    return small


@pytest.fixture
def card():
    """The card, for the tests marked ``cuda``; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
