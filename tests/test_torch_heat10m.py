"""The benchmark's heat10m configuration at a small size on the CPU: its
field and plain reference operator (``benchmark/reference/``, loaded by
path as the harness loads them) against the port's heat grid, and the
port's own path — ``setup_structured`` on the inexact PCG route,
``make_structured_inner``, ``refined_solve_device`` — against that
reference and a dense float64 solve.

Tolerances: the field's arrays equal ``heat_grid``'s bit for bit (the
same float64 arithmetic in the same order); the reference product
agrees with the port's float64 products to 1e-13 relative (the same
elements summed in another order); every refined answer meets the
configuration's ||b - A x|| / ||b|| <= 1e-8 by the reference.  Against
the dense solve x_d = A^-1 b the bound is the condition number's in the
energy norm: for any x, ||x - A^-1 b||_A <= ||r|| / sqrt(lambda_min)
and ||A^-1 b||_A >= ||b|| / sqrt(lambda_max), so
||x - x_d||_A / ||x_d||_A <= sqrt(kappa(A)) (rho_x + rho_d), rho the
relative residuals of the two answers, with 1% for the rounding of the
eigenvalues and of the norms.  At 16^3 kappa(A) is 8.7e11: the
Euclidean bound kappa(A) (rho_x + rho_d) reads 3e2-9e2 and says nothing,
the energy bound reads 3e-4-9e-4 against measured errors of 1e-9."""

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov.refine import refined_solve_device
from geneo4petsc_tpu_torch.structured import fdm
from geneo4petsc_tpu_torch.structured import solve as ssolve
from geneo4petsc_tpu_torch.structured.decompose import \
    StructuredDecomposition
from geneo4petsc_tpu_torch.structured.geneo import setup_structured
from geneo4petsc_tpu_torch.structured.grid import (global_stencil,
                                                   heat_grid, laplacian_grid)
from geneo4petsc_tpu_torch.structured.solvers import PCGSolver

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
FIELD = dict(dim=3, kappa_max=1e4, interp="minmax", weak_scaling=1,
             lbd=1.0, dt=0.1)
TOL = 1e-8


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _g4pbench_program():
    """The harness's ``g4pbench.program`` (a package: loaded with its
    folder as its search path)."""
    if "g4pbench" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "g4pbench", BENCH / "g4pbench" / "__init__.py",
            submodule_search_locations=[str(BENCH / "g4pbench")])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["g4pbench"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module("g4pbench.program")


heat_field = _load("reference/fields/heat.py", "bench_heat_field")
heat_7point = _load("reference/heat_7point.py", "bench_heat_7point")
with open(BENCH / "configs" / "heat10m.json") as f:
    CFG = json.load(f)


def _program_grid(size):
    return heat_grid(size, 3, 1e4, "minmax", lbd=1.0, dt=0.1)


@pytest.mark.parametrize("size", [12, 16])
def test_heat_field_is_the_programs(size):
    f = heat_field.make(dict(FIELD, size=size))
    g = _program_grid(size)
    assert tuple(f["shape"]) == tuple(g.shape)
    assert f["n_dof"] == g.n_nodes and f["separable"] is False
    assert np.array_equal(f["kappa"], g.kappa)
    for a in range(3):
        for got, want in ((f["edge_off"][a], g.edge_off(a)),
                          (f["edge_diag"][a], g.edge_diag(a))):
            assert got.dtype == np.float64
            assert got.tobytes() == np.asarray(want, np.float64).tobytes()
    assert f["bc_val"].tobytes() == np.asarray(g.bc_val(),
                                               np.float64).tobytes()


def test_the_configuration_is_the_field_of_the_cell():
    """heat10m.json's field is the 216^3 heat step of heat_grid(216, 3, 1e4, "minmax"), and
    its options are SORAS,H2 with the inexact level-1."""
    assert CFG["field"] == dict(FIELD, kind="heat", size=216)
    assert CFG["n_dof"] == 216 ** 3
    g = CFG["geneo"]
    assert (g["lvl1"], g["lvl2"], g["cut"]) == ("SORAS", "H2", 4)
    assert g["dls1"] == {"rtol": 0.05, "max_it": 40}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_product_is_the_programs(seed):
    f = heat_field.make(dict(FIELD, size=12))
    ref = heat_7point.build(f, CFG)
    g = _program_grid(12)
    x = torch.randn(g.n_nodes, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    y = ref.matvec(x)
    host = torch.from_numpy(g.matvec(x.numpy()))
    dev = global_stencil(g, torch.float64, "cpu").matvec(x)
    for other in (host, dev):
        assert float((y - other).norm() / y.norm()) <= 1e-13


def _options():
    o = GenEOOptions()
    _g4pbench_program().set_options(o, CFG["geneo"])
    return o


@pytest.fixture(scope="module")
def pcg_route():
    """heat 16^3, 2 x 2 x 2 boxes, overlap 2, the configuration's
    options, every local solve on the PCG route a 58^3 box takes
    (``bt_budget_bytes=0``); the PCG counters' change over the set-up;
    the reference and its dense matrix, assembled by probing."""
    g = _program_grid(16)
    sd = StructuredDecomposition(g, (2, 2, 2), 2)
    n0, i0 = PCGSolver.solves, PCGSolver.iterations
    pc, stats = setup_structured(sd, _options(), b=None,
                                 dtype=torch.float32, device="cpu",
                                 bt_budget_bytes=0)
    delta = (PCGSolver.solves - n0, PCGSolver.iterations - i0)
    ref = heat_7point.build(heat_field.make(dict(FIELD, size=16)), CFG)
    eye = torch.eye(ref.n, dtype=torch.float64)
    a = torch.stack([ref.matvec(eye[i]) for i in range(ref.n)], dim=1)
    return dict(grid=g, pc=pc, stats=stats, delta=delta, ref=ref, a=a,
                eig=torch.linalg.eigvalsh(a),
                inner=ssolve.make_structured_inner(pc, 2000, "cg"),
                gop64=global_stencil(g, torch.float64, "cpu"))


def _rhs(route, seed):
    x_s = torch.randn(route["ref"].n, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(seed))
    return route["ref"].matvec(x_s)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_pcg_route_solve_meets_the_reference(pcg_route, seed):
    r = pcg_route
    assert type(r["pc"].l1).__name__ == "PCGSolver" \
        and not r["pc"].l1_exact
    b = _rhs(r, seed)
    out = refined_solve_device(r["gop64"], b, r["inner"], tol=TOL)
    assert out.converged
    rho_x = r["ref"].relative_residual(out.x, b)
    assert rho_x <= TOL
    a = r["a"]
    x_d = torch.linalg.solve(a, b)
    rho_d = r["ref"].relative_residual(x_d, b)
    lam = r["eig"]
    assert float(lam[0]) > 0

    def energy(v):
        return float(torch.sqrt(v @ (a @ v)))

    err = energy(out.x - x_d) / energy(x_d)
    bound = float(torch.sqrt(lam[-1] / lam[0])) * (rho_x + rho_d)
    assert err <= 1.01 * bound, (err, bound)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_float32_control_fails_the_check(pcg_route, seed):
    """The harness's control, the float32 path asked for the whole
    tolerance, reads above the limit: the check tells the precisions
    apart."""
    r = pcg_route
    b = _rhs(r, seed)
    ctl = _g4pbench_program().float32_solve(r["gop64"], b, r["inner"], TOL)
    assert r["ref"].relative_residual(ctl.x, b) > TOL


def test_shift_invert_counts_by_pencil(pcg_route):
    """On the PCG route each pencil's shift-invert PCG ran, and the two
    pencils' counts are all the set-up's PCG work."""
    counts = pcg_route["stats"].shift_invert_pcg
    assert set(counts) == {"tau", "gamma"}
    for solves, its in counts.values():
        assert solves > 0 and its > 0
    assert tuple(map(sum, zip(*counts.values()))) == pcg_route["delta"]


@pytest.mark.parametrize("case", ["heat-exact", "lap-fdm"])
def test_shift_invert_counts_are_none_on_exact_routes(case):
    """The block-tridiagonal route (heat, the default budget) and the
    separable FDM route (laplacian, GenEO-1) run no shift-invert PCG."""
    o = GenEOOptions()
    o.els2.type, o.els2.max_it = "lobpcg", 50
    if case == "heat-exact":
        g = _program_grid(12)
        o.lvl1, o.lvl2, o.cut = "SORAS", "H2", 4
        want = {"tau", "gamma"}
    else:
        g = laplacian_grid(12, 3, 1e4, "minmax")
        o.lvl1, o.lvl2, o.cut = "ASM", "E1", 2
        want = {"tau"}
    sd = StructuredDecomposition(g, (2, 2, 2), 1)
    assert fdm.fdm_eligible(sd) == (case == "lap-fdm")
    n0 = PCGSolver.solves
    _pc, stats = setup_structured(sd, o, b=None, dtype=torch.float32,
                                  device="cpu")
    assert PCGSolver.solves == n0
    assert set(stats.shift_invert_pcg) == want
    assert all(v is None for v in stats.shift_invert_pcg.values())
