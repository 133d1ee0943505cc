"""The control of the correctness check comes out not correct, the
program's own answer correct; and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have.
"""

import dataclasses
import time

import numpy as np
import pytest

from conftest import ROOT, shrink
from g4pbench import program, runner
from g4pbench.control import readings
from geneo4petsc_tpu_torch.krylov import refine
from geneo4petsc_tpu_torch.structured import solve as ssolve

CELLS = ["lap10m.fresh", "lap10m.reuse"]
SEED = 2**31 + 5


def _check_control(cell, device, size):
    rows = readings(ROOT, cell, [11, 12, 13], device, program=True,
                    config_override=shrink(size))
    for r in rows:
        assert r["control_residual"] > r["limit"], r
        assert r["program_residual"] <= r["limit"], r


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    _check_control(cell, "cpu", 12)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    _check_control(cell, card, 48)


def _run(cell):
    return runner.run_cell(ROOT, cell, SEED, 0.2, False, "cpu",
                           time.perf_counter(), config_override=shrink(12))


def _replace_refinement(monkeypatch, solve):
    """Every route of the timed path to the float64 refinement goes to
    ``solve`` instead."""
    monkeypatch.setattr(refine, "refined_solve_device", solve)
    monkeypatch.setattr(ssolve, "refined_solve_device", solve)


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_timed_path_is_not_correct(cell, monkeypatch):
    """The control put in the program's place, through a whole run: the
    float32 path believes it converged, and the check says no."""
    _replace_refinement(monkeypatch, program.float32_solve)
    result, checks = _run(cell)
    assert result["failed"] == 0
    assert result["correct"] is False
    assert dict((c[0], c[1]) for c in checks)["residual_max"] > 1e-8


def _unchanged(x):
    """The solve returns the state it started from."""
    return x * 0


def _half(x):
    """Half of the unknowns left out, the mean of the rest in their
    place."""
    y = x.copy() if isinstance(x, np.ndarray) else x.clone()
    h = y.shape[0] // 2
    y[h:] = y[:h].mean()
    return y


def _altered(x):
    """The answer altered where it is produced: off by a millionth of
    itself."""
    return x * (1.0 + 1e-6)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    real = refine.refined_solve_device

    def broken(*args, **kw):
        res = real(*args, **kw)
        return dataclasses.replace(res, x=fault(res.x))

    _replace_refinement(monkeypatch, broken)
    result, checks = _run(cell)
    assert result["failed"] == 0        # the program believes it converged
    assert result["correct"] is False
    assert dict((c[0], c[1]) for c in checks)["residual_max"] > 1e-8


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"] is True
    assert result["device"]["platform"] == "cpu"
    assert dict((c[0], c[1]) for c in checks)["checked_ops"] >= 1
