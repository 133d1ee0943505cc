"""The thread helpers of tests/_threads.py: the budget of a worker, and
the MKL hang that ``torch_threads`` exists to prevent.

This module loads the thread budget and the per-test time limit
(tests/_time_limit.py) as plugins: pytest registers the plugins that a
collected module names for the whole session, before any test runs.  A
run that does not collect this file has neither."""

import os
import subprocess
import sys

import pytest

# imported as plugins, not by name here: a module imported before it is
# registered cannot have its asserts rewritten
pytest_plugins = ["_threads", "_time_limit"]

HERE = os.path.dirname(os.path.abspath(__file__))

# a pin of two threads, then a batched LU of torch's CPU: without MKL's
# settings given back the solve prints "Parameter 6 was incorrect on
# entry to DLASWP" and never returns (torch 2.13 CPU)
_PIN_THEN_SOLVE = f"""
import sys
sys.path.insert(0, {HERE!r})
import torch
from _threads import torch_threads

with torch_threads(2):
    pass
g = torch.Generator().manual_seed(0)
a = torch.rand(8, 216, 216, dtype=torch.float64, generator=g) \\
    + 216 * torch.eye(216, dtype=torch.float64)
b = torch.rand(8, 216, 3, dtype=torch.float64, generator=g)
x = torch.linalg.solve(a, b)
print(float((a @ x - b).abs().max()))
"""


@pytest.mark.timeout_s(60)
def test_a_batched_solve_returns_after_a_pin(request):
    from _time_limit import wait_s

    proc = subprocess.run([sys.executable, "-c", _PIN_THEN_SOLVE],
                          capture_output=True, text=True,
                          timeout=wait_s(request.node), check=False)
    assert proc.returncode == 0, proc.stderr
    assert "DLASWP" not in proc.stdout + proc.stderr
    assert float(proc.stdout.split()[-1]) < 1e-10


@pytest.mark.parametrize("workers,cores,want", [
    ("1", 8, 8), ("6", 8, 2), ("4", 8, 2), ("2", 8, 4), ("6", 1, 2)])
def test_budget_shares_the_cores_with_a_floor_of_two(monkeypatch, workers,
                                                     cores, want):
    from _threads import budget

    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert budget() == want
