"""The elastic backend's operators (structured/elastic.py) of the PyTorch
port against the JAX package, on the same seeded inputs (float64, on the
CPU).

Tolerances: the global and local cell-sum products agree to 1e-13
relative (the same 24 x 24 element products, summed in the BLAS's order);
the gathered fields and the surrogate's stencil fields agree to 1e-14;
repeated applies give the same bits; the same JAX preconditioner applied
by the port agrees to 1e-12 with level-1 solves at rtol 1e-11; from the
JAX package's LOBPCG start block the per-domain coarse dimensions are
equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.structured import elastic as jel
from geneo4petsc_tpu.structured import solvers as jsolvers
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.perf.lobpcg_start import jax_start
from geneo4petsc_tpu_torch.structured import elastic as el
from geneo4petsc_tpu_torch.structured import solvers as tsolvers
from geneo4petsc_tpu_torch.utils.convert import elastic_from_tree

from _threads import torch_threads

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: run torch on one intra-op
    thread, so that parallel test workers do not oversubscribe the
    cores (threads spinning on tiny ops cost more than they save)."""
    with torch_threads(1):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _to_jax_layout(v: torch.Tensor) -> np.ndarray:
    """Port [d, (m,) 3, z, y, x] -> JAX [d, z, y, x, 3(, m)]."""
    a = v.numpy()
    if a.ndim == 5:
        return np.moveaxis(a, 1, -1)
    return np.transpose(a, (0, 3, 4, 5, 2, 1))


def test_q1_hex_stiffness_and_rigid_modes():
    k = el.q1_hex_stiffness(1.0, 0.3)
    np.testing.assert_array_equal(k, jel.q1_hex_stiffness(1.0, 0.3))
    w = np.linalg.eigvalsh(k)
    assert int(np.sum(np.abs(w) < 1e-12)) == 6 and w[6] > 0.05
    # the six rigid-body modes of a unit cell lie in K0's kernel
    modes = el.rigid_modes((2, 2, 2))            # [6, 3, z, y, x]
    u = np.zeros((6, 24))
    for n, (dx, dy, dz) in enumerate(el._CORNERS):
        for c in range(3):
            u[:, 3 * n + c] = modes[:, c, dz, dy, dx]
    assert np.abs(u @ k).max() < 1e-12
    assert np.linalg.matrix_rank(u) == 6


@pytest.mark.parametrize("cols", [0, 2])
def test_elastic_op_matches_jax_and_host(cols):
    g = el.elastic_grid(5, kappa_max=100.0, interp="quad")
    jg = jel.elastic_grid(5, kappa_max=100.0, interp="quad")
    rng = np.random.default_rng(0)
    op = el.elastic_op(g, torch.float64, CPU)
    jop = jel.elastic_op(jg, jnp.float64)
    if cols:
        x = rng.standard_normal((cols, g.n_dof))
        got = op.matvec(torch.tensor(x)).numpy()
        want = np.asarray(jop.matvec(jnp.asarray(x.T))).T
        host = np.stack([g.matvec(v) for v in x])
    else:
        x = rng.standard_normal(g.n_dof)
        got = op.matvec(torch.tensor(x)).numpy()
        want = np.asarray(jop.matvec(jnp.asarray(x)))
        host = g.matvec(x)
    assert _rel(got, want) <= 1e-13
    assert _rel(got, host) <= 1e-13
    again = op.matvec(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, again)


def test_elastic_op_z_slabs_equal_one_pass():
    """A byte budget cuts the cell sum into z slabs: the same product."""
    g = el.elastic_grid(6, kappa_max=100.0, interp="minmax")
    x = torch.tensor(np.random.default_rng(1).standard_normal(g.n_dof))
    whole = el.elastic_op(g, torch.float64, CPU).matvec(x)
    slabs = el.elastic_op(g, torch.float64, CPU, budget_bytes=1).matvec(x)
    assert _rel(slabs.numpy(), whole.numpy()) <= 1e-14


@pytest.fixture(scope="module")
def soras_setup():
    """SORAS,0 (Robin level-1 solves) at size 6 on 2x2x1 boxes, overlap
    1, in both packages, with the surrogates' stencils captured."""
    g = el.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    jg = jel.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    seen = {"jax": [], "port": []}
    jsur, tsur = jsolvers.surrogate_fdm, tsolvers.surrogate_fdm

    def jkeep(st, *a, **kw):
        seen["jax"].append(st)
        return jsur(st, *a, **kw)

    def tkeep(st, *a, **kw):
        seen["port"].append(st)
        return tsur(st, *a, **kw)

    jo = JaxGenEOOptions()
    jo.lvl1, jo.lvl2 = "SORAS", "0"
    jo.dls1.rtol, jo.dls1.max_it = 1e-11, 500
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "SORAS", "0"
    o.dls1.rtol, o.dls1.max_it = 1e-11, 500
    jsolvers.surrogate_fdm, tsolvers.surrogate_fdm = jkeep, tkeep
    try:
        jpc, _ = jel.setup_elastic(jg, (2, 2, 1), 1, jo, dtype=jnp.float64)
        pc, _ = el.setup_elastic(g, (2, 2, 1), 1, o, dtype=torch.float64,
                                 device=CPU)
    finally:
        jsolvers.surrogate_fdm, tsolvers.surrogate_fdm = jsur, tsur
    return g, jpc, pc, seen


def test_local_fields_match_jax(soras_setup):
    _g, jpc, pc, _ = soras_setup
    rob, jrob = pc.l1.st, jpc.l1.st
    for got, want in ((rob.dir_op.cw, jrob.dir_op.cw),
                      (rob.dir_op.diag_add, jrob.dir_op.diag_add),
                      (rob.neu_op.cw, jrob.neu_op.cw),
                      (rob.neu_op.diag_add, jrob.neu_op.diag_add),
                      (rob.border, jrob.border), (pc.pou, jpc.pou),
                      (pc.maskf, jpc.maskf)):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-14
    assert rob.dir_op.pads == tuple(jrob.dir_op.pads) == (0, 1, 1)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["neumann", "dirichlet", "robin"])
def test_local_elastic_matches_jax(soras_setup, kind, m):
    """Neumann (1/cell_mult weights), dilated Dirichlet (zero-embedded
    input on the one-layer-dilated window) and Robin products, on one
    vector and on a block of two."""
    _g, jpc, pc, _ = soras_setup
    rob, jrob = pc.l1.st, jpc.l1.st
    op, jop = {"neumann": (rob.neu_op, jrob.neu_op),
               "dirichlet": (rob.dir_op, jrob.dir_op),
               "robin": (rob, jrob)}[kind]
    d, sz, sy, sx = pc.maskf.shape
    shape = (d, 3, sz, sy, sx) if m == 1 else (d, m, 3, sz, sy, sx)
    x = torch.tensor(np.random.default_rng(2).standard_normal(shape))
    got = op.matvec(x)
    want = np.asarray(jop.matvec(jnp.asarray(_to_jax_layout(x))))
    assert _rel(_to_jax_layout(got), want) <= 1e-13
    assert torch.equal(got, op.matvec(x))


def test_surrogate_stencil_matches_jax(soras_setup):
    """The scalar surrogate of the level-1 operator: its stencil fields
    (diagonal and the three axis couplings) equal JAX's."""
    _g, _jpc, _pc, seen = soras_setup
    assert len(seen["jax"]) == len(seen["port"]) == 1
    jst, st = seen["jax"][0], seen["port"][0]
    assert _rel(st.diag.numpy(), jst.diag) <= 1e-14
    for a in range(3):
        assert _rel(st.offs[a].numpy(), jst.offs[a]) <= 1e-14


def test_jax_pc_applies_the_same_in_the_port(soras_setup):
    """elastic_from_tree carries the JAX preconditioner across: the port
    applies the very same operator, inexact PCG local solve and apply."""
    g, jpc, _pc, _ = soras_setup
    tp = elastic_from_tree(jax.tree_util.tree_map(np.asarray, jpc), CPU)
    x = np.random.default_rng(3).standard_normal(g.n_dof)
    for name, tol in (("matvec", 1e-14), ("_local_solve", 1e-12),
                      ("apply", 1e-12)):
        got = getattr(tp, name)(torch.tensor(x)).numpy()
        want = np.asarray(getattr(jpc, name)(jnp.asarray(x)))
        assert _rel(got, want) <= tol, name


def test_tf32_is_refused():
    """The float32 cell products run at full float32 precision: a TF32
    setting is refused before any work."""
    g = el.elastic_grid(4)
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "ASM", "0"
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            el.setup_elastic(g, (2, 1, 1), 1, o, device=CPU)
        with pytest.raises(RuntimeError, match="full float32"):
            el.solve_elastic(g, (2, 1, 1), 1, o, device=CPU)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_jax_start_rebuilds_the_float64_draw():
    got = jax_start(2, 300, 8, torch.float64).numpy()
    want = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 300, 8),
                                      jnp.float64))
    assert _rel(got, want) <= 1e-13


def test_lobpcg_route_floating_slab_matches_jax():
    """GenEO-1 by matrix-free LOBPCG on a z-divided grid (the top slab
    floats: at least its six rigid-body modes), from the JAX package's
    start block: equal per-domain coarse dimensions and CG iterations."""
    g = el.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    jg = jel.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    _xt, b = g.manufactured_rhs()
    jo = JaxGenEOOptions()
    jo.lvl1, jo.lvl2 = "ASM", "1"
    jo.els2.type = "lobpcg"
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "ASM", "1"
    o.els2.type = "lobpcg"
    jpc, jst = jel.setup_elastic(jg, (1, 1, 2), 1, jo, dtype=jnp.float64)
    jr = jax_cg(jpc.matvec, jnp.asarray(b), jpc.apply, rtol=1e-8,
                flexible=True)
    pc, st = el.setup_elastic(g, (1, 1, 2), 1, o, dtype=torch.float64,
                              device=CPU, lobpcg_start=jax_start)
    r = cg_solve(pc.matvec, torch.tensor(b), pc.apply, rtol=1e-8,
                 flexible=True)
    assert int(st.real_dim_e[1]) >= 6
    np.testing.assert_array_equal(st.real_dim_e, jst.real_dim_e)
    np.testing.assert_array_equal(st.nicolaides, jst.nicolaides)
    assert r.reason > 0 and int(jr.reason) > 0
    assert r.its == int(jr.its)
