"""The structured path's operators of the PyTorch port against the JAX
package, on the same seeded inputs (float64, on the CPU).

Tolerances: the global and local stencil products agree to 1e-14 / 1e-13
relative (the same products, summed in the same order up to fused
multiply-adds); the halo gather is a pure copy (exact) and its adjoint
agrees to 1e-14 and satisfies <Gx, y> = <x, G^T y> to 1e-13; the FDM
solve agrees with JAX and with the stencil operator to 1e-11 (six dense
transforms with condition numbers up to ~1e4); inertia counts are
exact; LOBPCG eigenvalues agree to 1e-8 relative from the same start
block; Krylov iteration counts and reasons are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.krylov import cg as jcg
from geneo4petsc_tpu.krylov import refine as jref
from geneo4petsc_tpu.models import laplacian as jlap
from geneo4petsc_tpu.ops.lobpcg import matfree_lobpcg as j_lobpcg
from geneo4petsc_tpu.structured import block_tridiag as jbt
from geneo4petsc_tpu.structured import fdm as jfdm
from geneo4petsc_tpu.structured import grid as jgrid
from geneo4petsc_tpu.structured import halo as jhalo
from geneo4petsc_tpu.structured import local_ops as jlo
from geneo4petsc_tpu.structured import solvers as jsolvers
from geneo4petsc_tpu.structured.decompose import \
    StructuredDecomposition as JSD
from geneo4petsc_tpu_torch.krylov import cg as tcg
from geneo4petsc_tpu_torch.krylov import refine as tref
from geneo4petsc_tpu_torch.models import laplacian as tlap
from geneo4petsc_tpu_torch.ops.lobpcg import matfree_lobpcg as t_lobpcg
from geneo4petsc_tpu_torch.perf.lobpcg_start import jax_start
from geneo4petsc_tpu_torch.structured import block_tridiag as tbt
from geneo4petsc_tpu_torch.structured import fdm as tfdm
from geneo4petsc_tpu_torch.structured import grid as tgrid
from geneo4petsc_tpu_torch.structured import halo as thalo
from geneo4petsc_tpu_torch.structured import local_ops as tlo
from geneo4petsc_tpu_torch.structured import solvers as tsolvers
from geneo4petsc_tpu_torch.structured.decompose import \
    StructuredDecomposition as TSD

CPU = torch.device("cpu")
CASES = [(8, 2, (2, 2, 1), 1), (12, 2, (3, 2, 1), 2), (8, 3, (2, 2, 2), 2)]
IDS = [f"{s}-{d}d-{g[0]}x{g[1]}x{g[2]}-L{L}" for s, d, g, L in CASES]


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """Compile the JAX reference with most XLA optimizations off: the
    same programs, compiled in about half the time.  Compiled programs
    are dropped before (every reference of this file is compiled the
    same way, whatever ran earlier in the process) and after (later
    tests compile their own with full optimization)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
    jax.clear_caches()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _grids(kind, size, dim):
    kw = dict(dim=dim, kappa_max=1000.0, interp="minmax")
    make = "heat_grid" if kind == "heat" else "laplacian_grid"
    return getattr(jgrid, make)(size, **kw), getattr(tgrid, make)(size, **kw)


def _decomps(size, dim, dg, L, kind="laplacian"):
    jg, tg = _grids(kind, size, dim)
    return JSD(jg, dg, L), TSD(tg, dg, L)


@pytest.mark.parametrize("kind", ["laplacian", "heat"])
@pytest.mark.parametrize("size,dim", [(9, 2), (6, 3)])
def test_global_stencil_matches_jax(kind, size, dim):
    jg, tg = _grids(kind, size, dim)
    x = np.random.default_rng(0).standard_normal(jg.n_nodes)
    want = np.asarray(jax.jit(jgrid.global_stencil(jg, jnp.float64).matvec)(
        jnp.asarray(x)))
    got = tgrid.global_stencil(tg, torch.float64, CPU).matvec(_t(x))
    assert _rel(got, want) <= 1e-14
    assert _rel(tg.matvec(x), jg.matvec(x)) == 0.0


@pytest.mark.parametrize("size,dim,dg,L", CASES, ids=IDS)
def test_decomposition_arrays_identical(size, dim, dg, L):
    jsd, tsd = _decomps(size, dim, dg, L)
    for name in ("inner", "pad", "local_shape", "n_dom"):
        assert getattr(tsd, name) == getattr(jsd, name)
    for a in range(3):
        np.testing.assert_array_equal(tsd.axis_node_mult(a),
                                      jsd.axis_node_mult(a))
        np.testing.assert_array_equal(tsd.edge_mult(a), jsd.edge_mult(a))
    np.testing.assert_array_equal(tsd.node_mult(), jsd.node_mult())
    np.testing.assert_array_equal(tsd.adjacency(), jsd.adjacency())
    np.testing.assert_array_equal(tsd.max_mult(), jsd.max_mult())
    for d in range(tsd.n_dom):
        np.testing.assert_array_equal(tsd.dom_gids(d), jsd.dom_gids(d))
    arg = f"--size {size} --dim {dim} --kappa 1000. minmax"
    jgen = jsd.to_generic(jlap.get_input(arg))
    tgen = tsd.to_generic(tlap.get_input(arg))
    np.testing.assert_array_equal(tgen.node_mult, jgen.node_mult)
    np.testing.assert_array_equal(tgen.elem_mult, jgen.elem_mult)
    for p in range(tsd.n_dom):
        np.testing.assert_array_equal(tgen.dom_nodes[p], jgen.dom_nodes[p])
        np.testing.assert_array_equal(tgen.elem_doms[p], jgen.elem_doms[p])
        for q in range(tsd.n_dom):
            np.testing.assert_array_equal(tgen.intersections[p][q],
                                          jgen.intersections[p][q])


@pytest.mark.parametrize("size,dim,dg,L", CASES, ids=IDS)
def test_halo_gather_and_scatter_add_match_jax(size, dim, dg, L):
    jsd, tsd = _decomps(size, dim, dg, L)
    shape, pad = tsd.grid.shape, tsd.pad
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, tsd.grid.n_nodes))
    # one vector, and a block of two ([k, n] here, [n, k] in JAX)
    got = thalo.halo_gather(_t(x[0]), shape, dg, pad)
    want = np.asarray(jhalo.halo_gather(jnp.asarray(x[0]), shape, dg, pad))
    np.testing.assert_array_equal(got.numpy(), want)
    gotb = thalo.halo_gather(_t(x), shape, dg, pad)
    wantb = np.asarray(jhalo.halo_gather(jnp.asarray(x.T), shape, dg, pad))
    np.testing.assert_array_equal(gotb.numpy(), np.moveaxis(wantb, -1, 3))

    y = rng.standard_normal(got.shape)
    sa = thalo.halo_scatter_add(_t(y), shape, dg, pad)
    want_sa = np.asarray(jhalo.halo_scatter_add(jnp.asarray(y), shape, dg,
                                                pad))
    assert _rel(sa, want_sa) <= 1e-14
    # adjoint identity <G x, y> = <x, G^T y>
    lhs = float((got * _t(y)).sum())
    rhs = float((_t(x[0]) * sa).sum())
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0)
    # a fixed order of additions: the same bits every time
    for _ in range(3):
        assert torch.equal(thalo.halo_scatter_add(_t(y), shape, dg, pad), sa)
    yb = rng.standard_normal(gotb.shape)
    sab = thalo.halo_scatter_add(_t(yb), shape, dg, pad)
    want_sab = np.asarray(jhalo.halo_scatter_add(
        jnp.asarray(np.moveaxis(yb, 3, -1)), shape, dg, pad)).T
    assert _rel(sab, want_sab) <= 1e-14


def _fields(jsd, tsd):
    pad1 = tuple(p + 1 if g > 1 else 0 for p, g in zip(tsd.pad,
                                                       tsd.dom_grid))
    jf = jlo.slice_inner(jlo.gather_fields(jsd, jnp.float64, pad=pad1), jsd)
    tf = tlo.slice_inner(tlo.gather_fields(tsd, torch.float64, pad=pad1,
                                           device=CPU), tsd)
    return jf, tf


def _stencils(jf, tf, kind):
    if kind == "robin":
        return jlo.robin_stencil(jf, 0.7), tlo.robin_stencil(tf, 0.7)
    return (getattr(jlo, f"{kind}_stencil")(jf),
            getattr(tlo, f"{kind}_stencil")(tf))


@pytest.mark.parametrize("kind", ["neumann", "dirichlet", "robin"])
@pytest.mark.parametrize("size,dim,dg,L", CASES, ids=IDS)
def test_local_stencil_matvec_matches_jax(size, dim, dg, L, kind):
    jsd, tsd = _decomps(size, dim, dg, L, "heat" if dim == 3 else
                        "laplacian")
    jf, tf = _fields(jsd, tsd)
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    jst, tst = _stencils(jf, tf, kind)
    assert _rel(tst.diag, jst.diag) <= 1e-13
    x = np.random.default_rng(2).standard_normal((3,) + tf.diag.shape)
    want = np.asarray(jst.matvec(jnp.asarray(x[0])))
    assert _rel(tst.matvec(_t(x[0])), want) <= 1e-13
    # a block [d, m, lz, ly, lx] against JAX's trailing block axis
    wantb = np.asarray(jst.matvec(jnp.asarray(np.moveaxis(x, 0, -1))))
    gotb = tst.matvec(_t(np.moveaxis(x, 0, 1)))
    assert _rel(gotb, np.moveaxis(wantb, -1, 1)) <= 1e-13


def _dense_axes(ax, shift):
    """Dense [n_dom, n, n] Kronecker sum T_z(x)D_y(x)D_x + D_z(x)T_y(x)D_x
    + D_z(x)D_y(x)T_x + shift * D_z(x)D_y(x)D_x of the 1-D axis operators
    (x fastest)."""
    out = []
    for p in range(ax.d[0].shape[0]):
        t, d = [], []
        for a in range(3):
            m = np.diag(ax.t_diag[a][p])
            if ax.t_off[a].shape[1]:
                m = m + np.diag(ax.t_off[a][p], 1) + np.diag(ax.t_off[a][p],
                                                            -1)
            t.append(m)
            d.append(np.diag(ax.d[a][p]))
        terms = [np.kron(np.kron(t[2] if a == 2 else d[2],
                                 t[1] if a == 1 else d[1]),
                         t[0] if a == 0 else d[0]) for a in range(3)]
        out.append(sum(terms) + shift * np.kron(np.kron(d[2], d[1]), d[0]))
    return np.stack(out)


@pytest.mark.parametrize("size,dim,dg,L", CASES, ids=IDS)
def test_fdm_solve_matches_jax_and_the_operator(size, dim, dg, L):
    jsd, tsd = _decomps(size, dim, dg, L)
    jf, tf = _fields(jsd, tsd)
    rng = np.random.default_rng(3)
    maskf = tf.mask.double()
    x = _t(rng.standard_normal(tf.diag.shape)) * maskf
    for kind, shift, st in (("dirichlet", 0.0, tlo.dirichlet_stencil(tf)),
                            ("neumann", 0.1, None)):
        jax_ = getattr(jfdm, f"{kind}_axes")(jsd)
        jfac = jfdm.fdm_factor(jax_, shift=shift, dtype=jnp.float64)
        tax = getattr(tfdm, f"{kind}_axes")(tsd)
        tfac = tfdm.fdm_factor(tax, shift=shift, dtype=torch.float64,
                               device=CPU)
        u = tfac.solve(x)
        # one compiled program each for JAX's solve and matvec
        assert _rel(u, jax.jit(jfdm.FDMFactor.solve)(
            jfac, jnp.asarray(x.numpy()))) <= 1e-11
        # a dense solve with the Kronecker-sum operator (+ shift * D)
        dense = _t(_dense_axes(tax, shift))
        n = dense.shape[-1]
        u_ref = torch.linalg.solve(dense, x.reshape(len(x), n, 1))
        assert _rel(u.reshape(len(x), n), u_ref.squeeze(-1)) <= 1e-11
        np.testing.assert_allclose(
            tfdm.axes_matvec(tax, x).numpy(),
            np.asarray(jax.jit(lambda v: jfdm.axes_matvec(jax_, v))(
                jnp.asarray(x.numpy()))),
            rtol=1e-13, atol=1e-13 * float(x.abs().max()) * 1e3)
        if st is not None:
            # the Kronecker-sum form is the Dirichlet stencil itself
            assert _rel(tfdm.axes_matvec(tax, x) * maskf,
                        st.matvec(x) * maskf) <= 1e-13
        # a block of two right-hand sides solves column by column
        xb = torch.stack([x, 2.0 * x], dim=1)
        assert _rel(tfac.solve(xb)[:, 1], 2.0 * u) <= 1e-13


@pytest.mark.parametrize("size,dim,dg,L", CASES, ids=IDS)
def test_block_tridiag_solve_and_inertia_match_jax(size, dim, dg, L):
    jsd, tsd = _decomps(size, dim, dg, L, "heat")
    jf, tf = _fields(jsd, tsd)
    jst, tst = jlo.dirichlet_stencil(jf), tlo.dirichlet_stencil(tf)
    axis = tlo.plane_axis(tsd.local_shape)

    def planes(st):
        return jlo.plane_coefficients(st, axis)

    # JAX's side as one compiled program per call (the in-plane strides
    # come from the stencil's static shape)
    jp = jax.jit(lambda st: planes(st)[::2])(jst)
    tp = tlo.plane_coefficients(tst, axis)
    assert _rel(tp[0], jp[0]) == 0.0 and _rel(tp[2], jp[1]) == 0.0
    jfac = jax.jit(lambda st: jbt.bt_factor(*planes(st)))(jst)
    tfac = tbt.bt_factor(*tp)
    x = np.random.default_rng(4).standard_normal(tp[0].shape + (2,))
    u = tbt.bt_solve(tfac, _t(x))
    assert _rel(u, jax.jit(jbt.bt_solve)(jfac, jnp.asarray(x))) <= 1e-11
    assert _rel(tbt.bt_solve(tfac, _t(x[..., 0])), u[..., 0]) <= 1e-14
    # the exact solver inverts the stencil through the plane layout
    bts = tsolvers.bt_build(tst, tsd.local_shape)
    xs = _t(np.random.default_rng(5).standard_normal(tst.diag.shape))
    assert _rel(tst.matvec(bts.solve(xs)), xs) <= 1e-11
    # inertia of an indefinite pencil A - theta B, per domain
    neu = tlo.neumann_stencil(tf)
    for theta in (0.3,):
        want = np.asarray(jax.jit(lambda a, b: jbt.bt_inertia(*planes(
            jsolvers.add_scaled(a, b, -theta))))(jlo.neumann_stencil(jf),
                                                 jst))
        tpen = tsolvers.add_scaled(neu, tst, -theta)
        got = tbt.bt_inertia(*tlo.plane_coefficients(tpen, axis)).numpy()
        np.testing.assert_array_equal(got, want)


def test_matfree_lobpcg_matches_jax_from_the_same_start():
    size, dim, dg, L = CASES[1]
    jsd, tsd = _decomps(size, dim, dg, L)
    jf, tf = _fields(jsd, tsd)
    tau = 0.1
    jneu, tneu = jlo.neumann_stencil(jf), tlo.neumann_stencil(tf)
    jpou = jnp.where(jf.mask, 1.0 / jnp.maximum(jf.mult, 1.0), 0.0)
    tpou = torch.where(tf.mask, 1.0 / tf.mult.clamp(min=1.0),
                       torch.zeros_like(tf.mult))
    jb = jsolvers.diag_congruence(jlo.dirichlet_stencil(jf), jpou)
    tb = tsolvers.diag_congruence(tlo.dirichlet_stencil(tf), tpou)
    jt = jfdm.fdm_factor(jfdm.neumann_axes(jsd), shift=tau,
                         dtype=jnp.float64)
    tt = tfdm.fdm_factor(tfdm.neumann_axes(tsd), shift=tau,
                         dtype=torch.float64, device=CPU)
    d, sz, sy, sx = tf.diag.shape
    n, k = sz * sy * sx, 3
    maskf = tf.mask.double()
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (d, n, k),
                                      jnp.float64))
    x0 = x0 * maskf.reshape(d, n, 1).numpy()
    box = (d, sz, sy, sx, -1)

    def jops():
        def wrap(f):
            return lambda v: f(v.reshape(box)).reshape(d, n, -1)
        return (wrap(jneu.matvec), wrap(jb.matvec),
                wrap(lambda v: jt.solve(v) * jnp.asarray(maskf.numpy())[
                    ..., None]))

    def tops():
        def wrap(f):
            return lambda v: f(v.reshape(d, -1, sz, sy, sx)).reshape(d, -1, n)
        return (wrap(tneu.matvec), wrap(tb.matvec),
                wrap(lambda v: tt.solve(v) * maskf.unsqueeze(1)))

    for max_it, tol in ((40, 1e-9),):
        ja, jbo, jto = jops()
        w_j, v_j, r_j = jax.jit(lambda x: j_lobpcg(
            ja, jbo, jto, jto(x), max_it=max_it, tol=tol))(jnp.asarray(x0))
        ta, tbo, tto = tops()
        w_t, v_t, r_t = t_lobpcg(ta, tbo, tto, tto(_t(x0).transpose(1, 2)),
                                 max_it=max_it, tol=tol)
        w_j, r_j = np.asarray(w_j), np.asarray(r_j)
        assert _rel(w_t, w_j) <= 1e-8
        # the converged prefix (the setup keeps pairs with res <= 30 tol)
        for thr in (1e-3, 3e-2):
            prefix = np.cumprod(r_t.numpy() <= thr, axis=1).sum(1)
            np.testing.assert_array_equal(
                prefix, np.cumprod(r_j <= thr, axis=1).sum(1))
    assert prefix.min() >= 1     # the longer run converged pairs


def test_rebuilt_jax_start_block_matches_jax():
    """The measuring tool's JAX start block (Threefry bits and XLA's
    float32 erfinv, rebuilt with torch) against jax.random.normal: the
    same draw to 3 units in the last place."""
    shape = (4, 3000, 2)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                        jnp.float32))
    got = jax_start(*shape, torch.float32).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert (np.abs(got - want) <= 3 * np.spacing(np.abs(want))).all()
    assert (got == want).mean() >= 0.9


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(np.logspace(-2, 0, n)) @ q.T, rng.standard_normal(n)


@pytest.mark.parametrize("flexible", [False, True])
def test_cg_flexible_matches_jax(flexible):
    a, b = _spd(60, 6)
    m = np.diag(1.0 / np.diag(a))
    want = jax.jit(lambda r: jcg.cg_solve(
        lambda v: jnp.asarray(a) @ v, r, lambda v: jnp.asarray(m) @ v,
        rtol=1e-10, flexible=flexible))(jnp.asarray(b))
    got = tcg.cg_solve(lambda v: _t(a) @ v, _t(b), lambda v: _t(m) @ v,
                       rtol=1e-10, flexible=flexible)
    assert (got.its, got.reason) == (int(want.its), int(want.reason))
    assert got.reason == 2
    assert _rel(got.x, want.x) <= 1e-8


def test_cg_stall_exit_matches_jax():
    """A residual that stops improving (a noisy preconditioner that is
    not SPD-consistent keeps CG from converging) ends with
    CONVERGED_STEP_LENGTH after stall_its iterations in both."""
    n = 40
    a = np.diag(np.linspace(1.0, 2.0, n))
    b = np.ones(n)
    # a rank-deficient preconditioner: CG never reduces the residual
    # along the dropped direction, so the norm plateaus
    m = np.eye(n)
    m[0, 0] = 0.0
    want = jax.jit(lambda r: jcg.cg_solve(
        lambda v: jnp.asarray(a) @ v, r, lambda v: jnp.asarray(m) @ v,
        rtol=1e-12, norm_type="unpreconditioned", stall_its=7))(
            jnp.asarray(b))
    got = tcg.cg_solve(lambda v: _t(a) @ v, _t(b), lambda v: _t(m) @ v,
                       rtol=1e-12, norm_type="unpreconditioned",
                       stall_its=7)
    assert (got.its, got.reason) == (int(want.its), int(want.reason))
    assert got.reason == 7


def test_refinement_routes_match_jax():
    """Both refinement drivers on one operator (a structured Laplacian;
    float32 CG inside, preconditioned by the float32 inverse of a
    shifted copy of the operator): the same outer passes, inner
    iterations within one."""
    jg, tg = jgrid.laplacian_grid(10, dim=2), tgrid.laplacian_grid(10, dim=2)
    jop = jgrid.global_stencil(jg, jnp.float64)
    top = tgrid.global_stencil(tg, torch.float64, CPU)
    a = np.stack([tg.matvec(e) for e in np.eye(tg.n_nodes)], axis=1)
    m = np.linalg.inv(a + 0.05 * np.diag(np.diag(a))).astype(np.float32)
    a32 = a.astype(np.float32)
    jinner = jref.make_inner_solver(lambda v: jnp.asarray(a32) @ v,
                                    lambda v: jnp.asarray(m) @ v)
    a32t, mt = torch.from_numpy(a32), torch.from_numpy(m)

    def tinner(r32, rtol):
        return tcg.cg_solve(lambda v: a32t @ v, r32, lambda v: mt @ v,
                            rtol=rtol, max_it=2000)

    _x, b = jg.manufactured_rhs()
    jd = jref.refined_solve_device(jop, jnp.asarray(b), jinner, tol=1e-8)
    jh = jref.refined_solve(None, None, b, lambda x: b - jg.matvec(x),
                            tol=1e-8, inner_solver=jinner)
    td = tref.refined_solve_device(top, _t(b), tinner, tol=1e-8)
    th = tref.refined_solve(b, lambda x: b - tg.matvec(x), tinner,
                            tol=1e-8)
    for got, want in ((td, jd), (th, jh)):
        assert got.converged and want.converged
        assert got.outer_its == want.outer_its
        assert abs(got.inner_its - want.inner_its) <= 1
        assert got.true_res <= 1e-8
    assert _rel(td.x, np.asarray(jd.x)) <= 1e-8


def test_inexact_local_solvers_match_jax():
    """The surrogate-FDM approximate inverse and the inexact PCG local
    solve (the route past the block-tridiagonal memory budget) on the
    heat grid's Dirichlet stencil."""
    jsd, tsd = _decomps(8, 3, (2, 2, 2), 2, "heat")
    jf, tf = _fields(jsd, tsd)
    jst, tst = jlo.dirichlet_stencil(jf), tlo.dirichlet_stencil(tf)
    jm, tm = jnp.asarray(jf.mask, jnp.float64), tf.mask.double()
    jpre = jsolvers.surrogate_fdm(jst, jm)
    tpre = tsolvers.surrogate_fdm(tst, tm)
    x = np.random.default_rng(7).standard_normal(tuple(tf.diag.shape))
    assert _rel(tpre.solve(_t(x)), jax.jit(jpre.solve)(jnp.asarray(x))) \
        <= 1e-11
    jpcg = jsolvers.PCGSolver(st=jst, pre=jpre, maskf=jm, rtol=1e-6,
                              max_it=50)
    tpcg, exact = tsolvers.select_local_solver(tst, tm, tsd.local_shape,
                                               rtol=1e-6, max_it=50,
                                               bt_budget_bytes=0)
    assert not exact
    u = tpcg.solve(_t(x))
    assert _rel(u, jax.jit(jpcg.solve)(jnp.asarray(x))) <= 1e-8
    # it solves to its tolerance: compare with the exact route
    bt, exact = tsolvers.select_local_solver(tst, tm, tsd.local_shape)
    assert exact
    assert _rel(u, bt.solve(_t(x) * tm)) <= 1e-4
