"""The structured path's general local solvers in the PyTorch port against
the JAX package, end to end on the CPU (``solve_structured``, float64).

The cases of the JAX package's tests/test_structured_general.py — ORAS
and SORAS with GenEO-0/1/2/H2/E2 (Robin blocks on the exact
block-tridiagonal route), the heat grid (mass term), a non-separable
inclusion grid on the exact route and, with the block-tridiagonal
budget at 0, on the inexact surrogate-FDM PCG route — run through both
packages from the same LOBPCG start block.  Each JAX solve runs once per
module.

Tolerances: equal per-domain coarse dimensions (GenEO-2: the pre-prune
per-domain counts and the total, as the JAX test holds them: which
dependent column the prune keeps is rounding); tau_loc / gamma_loc to
1e-12; equal outer passes; equal inner iterations, within 1 for
SORAS,H2 / E2 (the JAX test's own band on the hybrid projections);
solutions within 1e-8 relative (exact routes) and 1e-7 (inexact)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.structured import grid as jgrid
from geneo4petsc_tpu.structured.solve import solve_structured as jax_solve
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.structured import geneo as tgeneo
from geneo4petsc_tpu_torch.structured import grid as tgrid
from geneo4petsc_tpu_torch.structured import solvers
from geneo4petsc_tpu_torch.structured.block_tridiag import bt_factor
from geneo4petsc_tpu_torch.structured.solve import solve_structured

from test_torch_structured_solve import (  # noqa: F401  (module fixture)
    _quick_jax_compiles, jax_start)

LAP = ("laplacian", 12, 2, 1e3, (3, 2, 1), 2)
HEAT = ("heat", 12, 2, 1e3, (3, 2, 1), 2)
# the inclusion grid of the JAX package's on-chip battery, cut to 12^3
INC = ("inclusion", 12, 3, 1e4, (2, 2, 2), 1)

# name: (grid, lvl, optim, inclusion-grid options, bt budget or None)
CASES = {
    **{f"lap-{lvl}": (LAP, lvl, optim, False, None) for lvl, optim in [
        ("ORAS,0", 1.0), ("SORAS,0", 1.0), ("SORAS,2", 1.0),
        ("SORAS,H2", 1.0), ("SORAS,E2", 1.0), ("ORAS,1", 0.02)]},
    "heat-ASM,1": (HEAT, "ASM,1", 0.0, False, None),
    "heat-SRAS,1": (HEAT, "SRAS,1", 0.0, False, None),
    "inc-ASM,E1": (INC, "ASM,E1", 0.0, True, None),
    "inc-SORAS,2": (INC, "SORAS,2", 0.0, True, None),
    "inc-ASM,E1-inexact": (INC, "ASM,E1", 0.0, True, 0),
}


def _grid(mod, spec):
    kind, size, dim, kmax, _dg, _L = spec
    if kind == "inclusion":
        return mod.inclusion_grid(size, dim=dim, kappa_max=kmax, n_inc=8)
    return getattr(mod, f"{kind}_grid")(size, dim=dim, kappa_max=kmax,
                                        interp="minmax")


def _opts(o, lvl, optim, inclusion):
    o.lvl1, o.lvl2 = lvl.split(",")
    o.optim = optim
    if inclusion:
        # tst/smoke_tpu.py's options for the inclusion grid
        o.els2.type, o.cut = "lobpcg", 2
        o.dls1.rtol, o.dls1.max_it = 0.05, 40
    else:
        # tests/test_structured_general.py's: the dense route, LOBPCG
        # settings as there
        o.els2.max_it, o.els2.rtol = 250, 1e-11
    return o


def _ksp_type(lvl):
    return "gmres" if lvl.startswith(("RAS", "ORAS")) else "cg"


def _run(pkg, name):
    spec, lvl, optim, inclusion, budget = CASES[name]
    _kind, _s, _d, _k, dg, overlap = spec
    if pkg == "jax":
        opts = _opts(JaxGenEOOptions(), lvl, optim, inclusion)
        with pytest.MonkeyPatch.context() as mp:
            if budget is not None:
                mp.setenv("GENEO_BT_BUDGET_GB", str(budget))
            return jax_solve(_grid(jgrid, spec), dg, overlap, geneo=opts,
                             ksp=JaxKSPOptions(type=_ksp_type(lvl)),
                             tol=1e-8, dtype=jnp.float64)
    opts = _opts(GenEOOptions(), lvl, optim, inclusion)
    return solve_structured(_grid(tgrid, spec), dg, overlap, geneo=opts,
                            ksp=KSPOptions(type=_ksp_type(lvl)), tol=1e-8,
                            dtype=torch.float64, device="cpu",
                            lobpcg_start=jax_start, bt_budget_bytes=budget)


# run by the JAX package in its default compile mode: under the quick
# compiles (jax_disable_most_optimizations) its CG under the
# non-symmetric SORAS preconditioner ends the first refinement pass 3%
# higher and takes 3 outer / 15 inner where its default build, and the
# port, take 2 / 13 (ROADMAP Queue 3, "SORAS,2 on the 12-grid")
FULL_COMPILE = ("lap-SORAS,2",)


@pytest.fixture(scope="module")
def jax_runs():
    runs = {name: _run("jax", name) for name in CASES
            if name not in FULL_COMPILE}
    jax.config.update("jax_disable_most_optimizations", False)
    jax.clear_caches()
    try:
        runs.update({name: _run("jax", name) for name in FULL_COMPILE})
    finally:
        jax.config.update("jax_disable_most_optimizations", True)
        jax.clear_caches()
    return runs


@pytest.mark.parametrize("name", list(CASES))
def test_general_solvers_match_jax(name, jax_runs):
    want, got = jax_runs[name], _run("torch", name)
    _spec, lvl, _optim, _inc, budget = CASES[name]
    assert got.converged and want.converged
    assert got.true_res <= 1e-8
    # the route: exact block-tridiagonal solves unless the budget is 0
    assert got.pc.l1_exact == (budget is None)
    assert isinstance(got.pc.l1, solvers.BTSolver if budget is None
                      else solvers.PCGSolver)
    if lvl.endswith("2"):
        np.testing.assert_array_equal(got.stats.raw_dim_e,
                                      want.stats.raw_dim_e)
        assert int(got.stats.real_dim_e.sum()) == \
            int(want.stats.real_dim_e.sum())
        np.testing.assert_allclose(got.stats.tau_loc, want.stats.tau_loc,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.stats.gamma_loc,
                                   want.stats.gamma_loc, rtol=1e-12)
    else:
        np.testing.assert_array_equal(got.stats.real_dim_e,
                                      want.stats.real_dim_e)
    np.testing.assert_array_equal(got.stats.nicolaides,
                                  want.stats.nicolaides)
    assert got.refined.outer_its == want.refined.outer_its
    band = 1 if lvl.endswith(("H2", "E2")) else 0
    assert abs(got.its - want.its) <= band
    x_ref = np.asarray(want.x, np.float64)
    assert (np.linalg.norm(got.x - x_ref) / np.linalg.norm(x_ref)
            <= (1e-8 if budget is None else 1e-7))


def _spy(monkeypatch):
    """Record (bt_budget_bytes, exact) of every select_local_solver
    call."""
    calls = []
    select = solvers.select_local_solver

    def spy(*args, **kw):
        solver, exact = select(*args, **kw)
        calls.append((kw.get("bt_budget_bytes"), exact))
        return solver, exact

    monkeypatch.setattr(solvers, "select_local_solver", spy)
    return calls


@pytest.mark.parametrize("budget", [0, None])
def test_bt_budget_argument_reaches_every_general_solve(monkeypatch,
                                                        budget):
    # ASM,E1 with LOBPCG on the inclusion grid: the level-1 solver and
    # the tau pencil's shift-invert preconditioner both come from
    # select_local_solver
    calls = _spy(monkeypatch)
    solves = solvers.PCGSolver.solves
    opts = _opts(GenEOOptions(), "ASM,E1", 0.0, True)
    kw = {} if budget is None else {"bt_budget_bytes": budget}
    out = solve_structured(tgrid.inclusion_grid(8, dim=3, kappa_max=1e4,
                                                n_inc=8), (2, 2, 2), 1,
                           geneo=opts, ksp=KSPOptions(type="cg"), tol=1e-8,
                           dtype=torch.float64, device="cpu", **kw)
    assert out.converged and out.true_res <= 1e-8
    assert len(calls) == 2
    assert all(b == budget for b, _ in calls)
    if budget is None:
        # the JAX package's default: 2 GB, far above this case's factors
        assert solvers.BT_BUDGET_BYTES == 2e9
        assert out.pc.l1_exact and all(exact for _, exact in calls)
    else:
        assert not out.pc.l1_exact and not any(exact for _, exact in calls)
        # the shift-invert LOBPCG and the level-1 applies ran PCG solves
        assert solvers.PCGSolver.solves > solves


def test_bt_budget_argument_reaches_the_gamma_pencil(monkeypatch):
    # SORAS,2 with LOBPCG: the Robin level-1 solver and the tau and
    # gamma pencils' shift-invert preconditioners
    from geneo4petsc_tpu_torch.structured.decompose import (
        StructuredDecomposition)

    calls = _spy(monkeypatch)
    sd = StructuredDecomposition(
        tgrid.inclusion_grid(8, dim=3, kappa_max=1e4, n_inc=8), (2, 2, 2),
        1)
    opts = _opts(GenEOOptions(), "SORAS,2", 0.0, True)
    pc, _ = tgeneo.setup_structured(sd, opts, dtype=torch.float64,
                                    device="cpu", bt_budget_bytes=0)
    assert not pc.l1_exact and isinstance(pc.l1, solvers.PCGSolver)
    assert calls == [(0, False)] * 3


def test_setup_structured_takes_the_budget(monkeypatch):
    from geneo4petsc_tpu_torch.structured.decompose import (
        StructuredDecomposition)

    sd = StructuredDecomposition(
        tgrid.inclusion_grid(8, dim=3, kappa_max=1e4, n_inc=8), (2, 2, 2),
        1)
    opts = _opts(GenEOOptions(), "ASM,0", 0.0, True)
    for budget, exact in ((0, False), (None, True), (1e12, True)):
        pc, _ = tgeneo.setup_structured(sd, opts, dtype=torch.float64,
                                        device="cpu",
                                        bt_budget_bytes=budget)
        assert pc.l1_exact == exact


def _planes(n_dom, p, s2, diag, couple):
    d = torch.full((n_dom, p, s2), diag, dtype=torch.float64)
    inplane = [(torch.full((n_dom, p, s2), -1.0, dtype=torch.float64), 1)]
    c = torch.full((n_dom, p - 1, s2), couple, dtype=torch.float64)
    return d, inplane, c


def test_bt_factor_refuses_an_operator_that_is_not_positive_definite():
    # SPD (diagonally dominant): a finite factor
    d, inplane, c = _planes(2, 3, 4, 3.0, -0.5)
    assert torch.isfinite(bt_factor(d, inplane, c).w).all()
    # plane 2 of domain 1 indefinite: cholesky_ex's info is read, not
    # dropped into a factor of NaNs
    d[1, 2] = -5.0
    with pytest.raises(ValueError, match="plane 2 of domain 1"):
        bt_factor(d, inplane, c)


def test_pcg_steps_equal_solve_and_count_iterations():
    from geneo4petsc_tpu_torch.structured import local_ops as lo
    from geneo4petsc_tpu_torch.structured.decompose import (
        StructuredDecomposition)

    sd = StructuredDecomposition(
        tgrid.inclusion_grid(8, dim=3, kappa_max=1e3, n_inc=4), (2, 1, 1),
        1)
    f = lo.gather_fields(sd, dtype=torch.float64, device="cpu")
    st = lo.dirichlet_stencil(f)
    maskf = f.mask.to(torch.float64)
    pcg = solvers.PCGSolver(st=st, pre=solvers.surrogate_fdm(st, maskf),
                            maskf=maskf, rtol=1e-6, max_it=100)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(st.diag.shape))) * maskf
    before = (solvers.PCGSolver.solves, solvers.PCGSolver.iterations)
    u = pcg.solve(x)
    its = solvers.PCGSolver.iterations - before[1]
    assert solvers.PCGSolver.solves == before[0] + 1 and 0 < its < 100
    m, _tol2, state = pcg.start(x)
    for _ in range(its):
        state = pcg.step(m, state)
    assert torch.equal(state[0] * m, u)


def test_checkpoint_key_holds_the_budget(tmp_path):
    # a setup cached under one budget is not loaded under another
    g = tgrid.inclusion_grid(8, dim=3, kappa_max=1e4, n_inc=8)
    opts = _opts(GenEOOptions(), "ASM,0", 0.0, True)
    for budget, exact in ((0, False), (None, True), (0, False)):
        out = solve_structured(g, (2, 2, 2), 1, geneo=opts,
                               ksp=KSPOptions(type="cg"), tol=1e-8,
                               dtype=torch.float64, device="cpu",
                               checkpoint_dir=str(tmp_path),
                               bt_budget_bytes=budget)
        assert out.converged and out.pc.l1_exact == exact
    assert len(list(tmp_path.iterdir())) == 2
