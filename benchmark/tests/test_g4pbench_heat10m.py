"""A dry run of the cell heat10m.reuse on the CPU at 16^3 (2 x 2 x 2
boxes, overlap 2): the result line, ``correct`` true for the program
and false for the control; and the heat reference loads nothing of the
program.  At this size the level-1 solver takes the exact
block-tridiagonal route; the inexact PCG route a 58^3 box takes is
tested in the port's own tests (``tests/test_torch_heat10m.py``)."""

import io
import json
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT
from g4pbench import program, runner
from g4pbench.control import readings
from geneo4petsc_tpu_torch.krylov import refine

CELL = "heat10m.reuse"
SEED = 2**33 + 19


def small(cfg):
    cfg = dict(cfg)
    cfg["field"] = dict(cfg["field"], size=16)
    cfg["decomposition"] = {"boxes": [2, 2, 2], "overlap": 2}
    return cfg


def _run(trace):
    return runner.run_cell(ROOT, CELL, SEED, 0.5, trace, "cpu",
                           time.perf_counter(), config_override=small)


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_is_correct(trace):
    result, checks = _run(bool(trace))
    out, err = io.StringIO(), io.StringIO()
    runner.emit(result, checks, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    spec = runner.Spec(ROOT)
    names = {m["name"] for m in (spec.per_layer(CELL) if trace
                                 else spec.end_to_end(CELL))}
    assert set(line["metrics"]) <= names
    if trace:
        assert "inner_iters.reuse" in line["metrics"]
    else:
        # the p90 needs two solves, which a loaded CPU may not fit in
        # the half-second window
        want = {"setup_s", "resolve_s"} | (
            {"resolve_p90_s"} if line["attempted"] >= 2 else set())
        assert want <= set(line["metrics"])


def test_control_is_not_correct(monkeypatch):
    """The float32 control in the refinement's place, through a whole
    run: it believes it converged, and the check says no; the control's
    and the program's readings on the seeds' first b fall on either side
    of the limit."""
    rows = readings(ROOT, CELL, [11, 12], "cpu", program=True,
                    config_override=small)
    for r in rows:
        assert r["control_residual"] > r["limit"], r
        assert r["program_residual"] <= r["limit"], r
    monkeypatch.setattr(refine, "refined_solve_device",
                        program.float32_solve)
    result, _checks = _run(False)
    assert result["failed"] == 0
    assert result["correct"] is False


def test_heat_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}]
import reference.heat_7point, reference.fields.heat
f = reference.fields.heat.make(dict(size=6, dim=3, kappa_max=1e4,
                                    interp="minmax"))
reference.heat_7point.build(f, {{"inp_eps": 1e-4}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "reference" in top
    assert not top & {"jax", "jaxlib", "flax", "geneo4petsc_tpu",
                      "geneo4petsc_tpu_torch", "g4pbench"}
