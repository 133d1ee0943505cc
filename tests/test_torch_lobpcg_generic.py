"""The generic path's iterative eigensolve (``els2 lobpcg``) of the
PyTorch port against the JAX package: batched LOBPCG on dense pencils,
the Sylvester inertia helpers, the LOBPCG branch of ``setup_geneo`` and
the float32 inner solve inside float64 refinement.

The LOBPCG start block is injected: both packages start from JAX's own
draw, jax.random.normal(PRNGKey(0), (d, n, k)).

Tolerances (float64 unless said): eigenvalues 1e-8 relative; LOBPCG
relative residuals 10% of themselves plus 1e-7 (a residual of an
unconverged Ritz pair is a difference of nearly equal vectors, so the
two packages' rounding over 30-50 iterations shows in it at that
size), kept-pair residuals of the setup 1e-5 absolute; counts equal,
but for which near-dependent coarse column the prune drops where its
pivot sits at the float64 floor (ROADMAP Queue 3).  The
float32 refinement is held to equal outer passes and coarse dimension
and to inner counts within +-3: near the float32 floor the inner CG ends
at a roundoff-decided iteration (ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.refine import \
    make_pc_inner_solver as jax_make_pc_inner_solver
from geneo4petsc_tpu.krylov.refine import refined_solve as jax_refined_solve
from geneo4petsc_tpu.models import heat as jax_heat
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.ops import batched_linalg as jax_bl
from geneo4petsc_tpu.ops.lobpcg import batched_lobpcg as jax_batched_lobpcg
from geneo4petsc_tpu.partition.decompose import \
    decompose_nodal_fast as jax_decompose_nodal_fast
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_partition_and_decompose
from geneo4petsc_tpu.precond import geneo as jax_geneo
from geneo4petsc_tpu_torch.assembly.assemble import assemble
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.krylov.refine import (make_pc_inner_solver,
                                                 refined_solve)
from geneo4petsc_tpu_torch.models import heat, laplacian
from geneo4petsc_tpu_torch.ops import batched_linalg as bl
from geneo4petsc_tpu_torch.ops.lobpcg import batched_lobpcg
from geneo4petsc_tpu_torch.partition.decompose import (decompose_nodal_fast,
                                                       partition_and_decompose)
from geneo4petsc_tpu_torch.partition.kway import partition_structured_grid
from geneo4petsc_tpu_torch.precond import geneo

from _threads import torch_threads

CPU = torch.device("cpu")
GEN_ARGS = "--size 16 --dim 2 --kappa 1000. minmax"


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


def jax_start(d, n, k, dtype):
    """JAX's start block (the draw inside its batched_lobpcg)."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (d, n, k), jdt)))


@pytest.fixture(scope="module")
def problem():
    """(JAX assembled, port assembled) of laplacian 16x16, 4 domains,
    overlap 1, float64."""
    ref_mesh = jax_laplacian.get_input(GEN_ARGS)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    mesh = laplacian.get_input(GEN_ARGS)
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    return ref, got


def _tau_pencil(ref):
    b = ref.batch
    return (np.array(jax_geneo._with_pad_diag(b.a_neu, b.mask, 1e6)),
            np.array(jax_geneo._dadird(b)))


@pytest.mark.parametrize("k,max_it,shift", [(4, 50, 0.1), (8, 30, 0.4)])
def test_batched_lobpcg_matches_jax(problem, k, max_it, shift):
    a, b = _tau_pencil(problem[0])
    w_ref, v_ref, r_ref = jax_batched_lobpcg(jnp.asarray(a), jnp.asarray(b),
                                             k=k, max_it=max_it, shift=shift)
    w, v, res = batched_lobpcg(torch.from_numpy(a), torch.from_numpy(b), k,
                               max_it=max_it, shift=shift,
                               x0=jax_start(a.shape[0], a.shape[1], k,
                                            torch.float64))
    w_ref = np.asarray(w_ref)
    assert w.shape == (a.shape[0], k) and v.shape == (a.shape[0], a.shape[1], k)
    assert np.abs(w.numpy() - w_ref).max() <= 1e-8 * np.abs(w_ref).max()
    np.testing.assert_allclose(res.numpy(), np.asarray(r_ref), rtol=0.1,
                               atol=1e-7)
    # the returned pairs are Ritz pairs of the pencil
    av = np.einsum("dij,djk->dik", a, v.numpy())
    bv = np.einsum("dij,djk->dik", b, v.numpy())
    rn = np.linalg.norm(av - bv * w.numpy()[:, None, :], axis=1)
    scale = np.linalg.norm(av, axis=1) + (np.abs(w.numpy()) + 1) * \
        np.linalg.norm(bv, axis=1)
    np.testing.assert_allclose(rn / scale, res.numpy(), rtol=1e-6, atol=1e-14)


def test_batched_lobpcg_default_start_is_seeded(problem):
    a, b = (torch.from_numpy(m) for m in _tau_pencil(problem[0]))
    w1, v1, _ = batched_lobpcg(a, b, 3, max_it=5)
    w2, v2, _ = batched_lobpcg(a, b, 3, max_it=5)
    assert torch.equal(w1, w2) and torch.equal(v1, v2)


def _spd_batch(d=4, n=12, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, n, n))
    return np.einsum("dij,dkj->dik", a, a) / n + 0.5 * np.eye(n)


def _inertia_cases():
    """The cases of tests/test_batched_linalg.py (a spectrum against
    theta, a padded batch) plus indefinite GenEO pencils."""
    d, n = 3, 10
    a = _spd_batch(d, n)
    eye = np.tile(np.eye(n), (d, 1, 1))
    full = np.ones((d, n), bool)
    cases = [(a, eye, np.full(d, th), full) for th in (0.5, 1.0, 2.0)]
    k = 5
    ap = np.tile(np.eye(8), (2, 1, 1))
    ap[:, :k, :k] = _spd_batch(2, k)[0]
    mask = np.zeros((2, 8), bool)
    mask[:, :k] = True
    cases.append((ap, np.tile(np.eye(8), (2, 1, 1)), np.full(2, 0.5), mask))
    return cases


def _ldlt_inertia_whole(s, mask):
    """The naive reference of ``ldlt_inertia``: JAX's algorithm as it
    stands, every pivot updating the whole matrix under a mask."""
    n = s.shape[-1]
    sel = mask[:, :, None] & mask[:, None, :]
    mat = (torch.where(sel, 0.5 * (s + s.transpose(-1, -2)), 0.0)
           + (~mask)[:, :, None] * torch.eye(n, dtype=s.dtype))
    trail = torch.arange(n)
    for j in range(n):
        piv = mat[:, j, j]
        safe = torch.where(piv.abs() > 1e-30, piv,
                           torch.where(piv < 0, -1e-30, 1e-30))
        upd = (mat[:, :, j] / safe[:, None])[:, :, None] * mat[:, j, None, :]
        scope = (trail > j)[:, None] & (trail > j)[None, :]
        mat = torch.where(scope, mat - upd, mat)
    d = mat.diagonal(dim1=-2, dim2=-1)
    return ((d < 0) & mask).sum(-1), ((d > 0) & mask).sum(-1)


@pytest.mark.parametrize("case", range(4))
def test_inertia_and_sylvester_counts_match_jax(case):
    a, b, theta, mask = _inertia_cases()[case]
    s = a - theta[:, None, None] * b
    ref_neg, ref_pos = jax_bl.ldlt_inertia(jnp.asarray(s), jnp.asarray(mask))
    syl_neg, syl_pos = jax_bl.sylvester_counts(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(theta), jnp.asarray(mask))
    t = {k: torch.from_numpy(v) for k, v in
         dict(a=a, b=b, theta=theta, mask=mask, s=s).items()}
    for fn in (bl.ldlt_inertia, _ldlt_inertia_whole):
        neg, pos = fn(t["s"], t["mask"])
        np.testing.assert_array_equal(neg.numpy(), np.asarray(ref_neg))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    neg, pos = bl.sylvester_counts(t["a"], t["b"], t["theta"], t["mask"])
    np.testing.assert_array_equal(neg.numpy(), np.asarray(syl_neg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(syl_pos))


@pytest.mark.parametrize("pencil", ["tau1", "tau", "gamma", "random"])
@pytest.mark.parametrize("theta", [0.05, 0.1, 0.4])
def test_blocked_inertia_equals_plain_on_geneo_pencils(problem, theta,
                                                       pencil):
    """The trailing-block LDL^T gives the counts of the whole-matrix
    reference (and JAX's) on the indefinite GenEO pencils A - theta B —
    GenEO-1's, GenEO-2's tau and gamma pencils (Robin parameter 0.3) —
    and on a random SPD batch against theta I."""
    batch = problem[1].batch
    if pencil == "tau1":
        a, b = geneo._pencil_tau_device(batch, 1e6)
    elif pencil == "random":
        a = torch.from_numpy(_spd_batch(4, batch.n_max, seed=3))
        b = torch.eye(batch.n_max, dtype=a.dtype).expand_as(a)
    else:
        a, b = geneo._pencil_g2_device(batch, 0.3, pencil)
    s, m = a - theta * b, batch.mask
    got = bl.ldlt_inertia(s, m)
    want = _ldlt_inertia_whole(s, m)
    ref = jax_bl.ldlt_inertia(jnp.asarray(s.numpy()), jnp.asarray(m.numpy()))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_lu_factor_nullpivot_matches_jax():
    """Singular matrix (rank 7): the fixed factorization equals JAX's and
    contributes ~0 along the null direction (MUMPS ICNTL(24)/CNTL(5))."""
    q, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((8, 8)))
    w = np.array([3.0, 2.5, 2.0, 1.5, 1.0, 0.5, 0.2, 0.0])
    a = q @ np.diag(w) @ q.T
    ref_lu, ref_piv = jax_bl.lu_factor_nullpivot(jnp.asarray(a))
    lu, piv = bl.lu_factor_nullpivot(torch.from_numpy(a[None]))
    np.testing.assert_allclose(lu[0].numpy(), np.asarray(ref_lu), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(piv[0].numpy() - 1, np.asarray(ref_piv))
    assert float(lu[0].diagonal().abs().max()) == 1e20
    rhs = a @ np.ones(8)
    x = bl.lu_solve((lu, piv), torch.from_numpy(rhs[None]))[0].numpy()
    assert np.isfinite(x).all()
    assert np.linalg.norm(a @ x - rhs) < 1e-6 * np.linalg.norm(rhs)


@pytest.mark.parametrize("lvl1,lvl2,cut,no_syl", [
    ("ASM", "E1", 4, False),
    ("ASM", "E1", 0, False),      # inertia-sized candidate block
    ("ASM", "1", 0, True),        # 8 candidates under -geneo_no_syl
    ("SORAS", "2", 4, False),     # guard columns, swapped gamma pencil
    ("SORAS", "E2", 0, True),
    ("SORAS", "2", 0, False),
])
def test_setup_geneo_lobpcg_matches_jax(problem, monkeypatch, lvl1, lvl2,
                                        cut, no_syl):
    ref, got = problem

    def opts(cls):
        g = cls()
        g.lvl1, g.lvl2, g.cut, g.no_syl = lvl1, lvl2, cut, no_syl
        g.els2.type = "lobpcg"
        return g

    ref_pc, ref_st = jax_geneo.setup_geneo(ref.batch, opts(JaxGenEOOptions),
                                           decomp=ref.decomp, a_csr=ref.a_csr)
    monkeypatch.setattr(geneo, "default_start", jax_start)
    pc, st = geneo.setup_geneo(got.batch, opts(GenEOOptions),
                               decomp=got.decomp, a_csr=got.a_csr)
    for name in ("raw_dim_e", "estim_dim_e", "nicolaides", "tau_loc",
                 "gamma_loc"):
        np.testing.assert_array_equal(getattr(st, name), getattr(ref_st, name))
    np.testing.assert_allclose(st.lobpcg_res, ref_st.lobpcg_res, rtol=0,
                               atol=1e-5)
    if (lvl2, cut) == ("2", 0):
        # one near-duplicate column of one domain has its pivoted-Cholesky
        # pivot within 0.3-13% above the float64 prune floor: whether
        # each package drops it turns on the start block and on how XLA
        # compiled the reference (ROADMAP Queue 3,
        # tests/_torch_roundoff_witness.py).  At most the pruned columns
        # of one domain differ; the iterations below stay equal.
        diff = np.flatnonzero(st.real_dim_e != ref_st.real_dim_e)
        assert diff.size <= 1
        assert np.abs(st.real_dim_e - ref_st.real_dim_e).sum() \
            <= max(ref_st.e_pruned, st.e_pruned)
    else:
        np.testing.assert_array_equal(st.real_dim_e, ref_st.real_dim_e)
    # equal iteration counts of the solve with each package's own PC
    rhs = np.random.default_rng(1).standard_normal(got.n_dof)
    ref_x0 = ref_pc.apply_q(jnp.asarray(rhs)) if ref_pc.eff_hybrid else None
    from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg_solve
    ref_res = jax_cg_solve(ref_pc.batch.matvec, jnp.asarray(rhs),
                           ref_pc.apply, x0=ref_x0, rtol=1e-8)
    b_t = torch.from_numpy(rhs)
    x0 = pc.apply_q(b_t) if pc.eff_hybrid else None
    res = cg_solve(got.batch.matvec, b_t, pc.apply, x0=x0, rtol=1e-8)
    assert (res.its, res.reason) == (int(ref_res.its), int(ref_res.reason))


def test_setup_geneo_lobpcg_prune_matches_jax(monkeypatch):
    """SORAS,2 with lobpcg and no cut away from the float64 prune floor
    (laplacian 24x24, 4 domains, overlap 1: no column near dependent,
    the smallest pivot of E 1.8e-3 against a floor of 2.4e-14): every
    count equal per domain, and equal iterations.  Nearer the floor
    (12x12, 16x16) which near-dependent column the prune drops is
    roundoff (ROADMAP Queue 3, ``tests/_torch_roundoff_witness.py``)."""
    args = "--size 24 --dim 2 --kappa 1000. minmax"
    ref_mesh = jax_laplacian.get_input(args)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    mesh = laplacian.get_input(args)
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    g, jg = GenEOOptions(), JaxGenEOOptions()
    for o in (g, jg):
        o.lvl1, o.lvl2, o.cut = "SORAS", "2", 0
        o.els2.type = "lobpcg"
    ref_pc, ref_st = jax_geneo.setup_geneo(ref.batch, jg, decomp=ref.decomp,
                                           a_csr=ref.a_csr)
    monkeypatch.setattr(geneo, "default_start", jax_start)
    pc, st = geneo.setup_geneo(got.batch, g, decomp=got.decomp,
                               a_csr=got.a_csr)
    assert st.e_pruned == ref_st.e_pruned == 0
    for name in ("raw_dim_e", "real_dim_e", "estim_dim_e", "nicolaides"):
        np.testing.assert_array_equal(getattr(st, name), getattr(ref_st, name))
    rhs = np.random.default_rng(1).standard_normal(got.n_dof)
    from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg_solve
    ref_res = jax_cg_solve(ref_pc.batch.matvec, jnp.asarray(rhs),
                           ref_pc.apply, rtol=1e-8)
    res = cg_solve(got.batch.matvec, torch.from_numpy(rhs), pc.apply,
                   rtol=1e-8)
    assert (res.its, res.reason) == (int(ref_res.its), int(ref_res.reason))


def test_geneo2_lobpcg_selection_parity_with_eigh(monkeypatch):
    """GenEO-2 (SORAS,2): the LOBPCG route keeps the same per-domain
    window selection as the dense eigh route, as the JAX package's
    tests/test_lobpcg.py pins it on heat and the reference's dummy
    tridiagonal problem (here a 1-D laplacian: tridiagonal), in both
    packages."""
    monkeypatch.setattr(geneo, "default_start", jax_start)
    cases = [("heat", "--size 12 --dim 2 --kappa 10000. minmax", 4),
             ("laplacian", "--size 12 --dim 1 --inpEps 0.", 2)]
    for gen, args, n_dom in cases:
        mods = {"heat": (heat, jax_heat),
                "laplacian": (laplacian, jax_laplacian)}[gen]
        mesh, ref_mesh = mods[0].get_input(args), mods[1].get_input(args)
        got = assemble(mesh, partition_and_decompose(mesh, n_dom,
                                                     add_overlap=1), CPU)
        ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
            ref_mesh, n_dom, add_overlap=1))
        counts = {}
        for els in ("eigh", "lobpcg"):
            g, jg = GenEOOptions(), JaxGenEOOptions()
            for o in (g, jg):
                o.lvl1, o.lvl2 = "SORAS", "2"
                o.els2.type = els
            _pc, st = geneo.setup_geneo(got.batch, g, decomp=got.decomp)
            _jpc, jst = jax_geneo.setup_geneo(ref.batch, jg,
                                              decomp=ref.decomp)
            counts[els] = st.raw_dim_e
            np.testing.assert_array_equal(st.raw_dim_e, jst.raw_dim_e)
        np.testing.assert_array_equal(counts["eigh"], counts["lobpcg"])


def test_pencils_on_device_equal_host_forms(problem):
    """The device-side pencil builders give the host _with_pad_diag
    forms bit for bit (here on CPU tensors)."""
    got = problem[1]
    batch = got.batch
    mask = batch.mask.numpy()
    a_neu, a_dir = batch.a_neu.numpy(), batch.a_dir.numpy()
    d = 1.0 / batch.mult.numpy()
    dadird = a_dir * d[:, :, None] * d[:, None, :]
    a_rob = geneo.robin_blocks(batch, 0.3).numpy()
    a, b = geneo._pencil_tau_device(batch, 1e6)
    np.testing.assert_array_equal(a.numpy(),
                                  geneo._with_pad_diag(a_neu, mask, 1e6))
    np.testing.assert_array_equal(b.numpy(), dadird)
    a, b = geneo._pencil_g2_device(batch, 0.3, "tau")
    np.testing.assert_array_equal(a.numpy(),
                                  geneo._with_pad_diag(a_neu, mask, 1e6))
    np.testing.assert_array_equal(b.numpy(), a_rob)
    a, b = geneo._pencil_g2_device(batch, 0.3, "gamma")
    np.testing.assert_array_equal(a.numpy(),
                                  geneo._with_pad_diag(a_rob, mask, 1e6))
    np.testing.assert_array_equal(b.numpy(), dadird)
    # and JAX's device builders, to the last bit but for XLA's fused
    # multiply-add in the Robin sum
    ref = problem[0].batch
    ja, jb = jax_geneo._pencil_g2_device(ref.a_neu, ref.a_dir, ref.mult,
                                         ref.mask, jnp.asarray(0.3), "gamma")
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


# torch intra-op threads of the port's side of the float32 refinement test
PINNED_THREADS = 4


@pytest.mark.parametrize("size", [16, 32])
def test_float32_refined_solve_matches_jax(size):
    """The large configuration at a small size: brick partition into 4x4,
    nodal fast decomposition, float32 assembly, ASM,E1 with LOBPCG cut 4
    and block inverses, the float32 PC inner CG (stall_its 50, x0 = Q r)
    inside float64 refinement to a true 1e-8."""
    args = f"--size {size} --dim 2 --kappa 10000. minmax"
    part = partition_structured_grid((size, size), (4, 4))
    ref_mesh = jax_laplacian.get_input(args)
    ref = jax_assemble(ref_mesh, jax_decompose_nodal_fast(ref_mesh, part, 16),
                       dtype=jnp.float32)
    g = JaxGenEOOptions()
    g.lvl1, g.lvl2, g.cut = "ASM", "E1", 4
    g.dls1.type, g.els2.type = "inverse", "lobpcg"
    ref_pc, ref_st = jax_geneo.setup_geneo(ref.batch, g, decomp=ref.decomp,
                                           a_csr=ref.a_csr)
    xt = np.arange(1.0, ref_mesh.n_nodes + 1)
    b = ref.a_csr @ xt
    ref_r = jax_refined_solve(None, None, b, lambda x: b - ref.a_csr @ x,
                              tol=1e-8, max_outer=14,
                              inner_solver=jax_make_pc_inner_solver(ref_pc))

    mesh = laplacian.get_input(args)
    got = assemble(mesh, decompose_nodal_fast(mesh, part, 16), CPU,
                   dtype=torch.float32)
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2, opts.cut = "ASM", "E1", 4
    opts.dls1.type, opts.els2.type = "inverse_pallas", "lobpcg"
    # the CPU GEMMs over unconverged float32 LOBPCG pairs sum in an order
    # that depends on torch's intra-op thread count, and the inner count
    # follows it (one thread: 37 at size 32; 2, 4 or 8 threads: 41): run
    # the port on PINNED_THREADS threads whatever the runner gives torch
    with torch_threads(PINNED_THREADS):
        pc, st = geneo.setup_geneo(got.batch, opts, decomp=got.decomp,
                                   a_csr=got.a_csr, lobpcg_start=jax_start)
        assert pc.l1_factor.dtype == torch.float32 and pc.eff_hybrid
        r = refined_solve(b, lambda x: b - got.a_csr @ x,
                          make_pc_inner_solver(pc), tol=1e-8, max_outer=14)
    np.testing.assert_array_equal(st.real_dim_e, ref_st.real_dim_e)
    assert r.converged and ref_r.converged and r.true_res <= 1e-8
    assert r.outer_its == ref_r.outer_its
    assert abs(r.inner_its - ref_r.inner_its) <= 3
    assert np.abs(r.x - xt).max() / xt.size <= 1e-6


def test_pc_inner_solver_gmres_and_plain_start():
    """make_pc_inner_solver on a PC that is not efficient-hybrid (its
    inner CG starts from zero, not from Q r) converges inside the
    refinement.  The inner solve is CG only: no caller of the port or
    of the JAX package asks it for GMRES."""
    mesh = laplacian.get_input("--size 12 --dim 2")
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1),
                   CPU, dtype=torch.float32)
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "1"
    pc, _ = geneo.setup_geneo(got.batch, opts)
    assert not pc.eff_hybrid
    b = got.a_csr @ np.arange(1.0, mesh.n_nodes + 1)
    r = refined_solve(b, lambda x: b - got.a_csr @ x,
                      make_pc_inner_solver(pc), tol=1e-9)
    assert r.converged and r.true_res <= 1e-9


def test_float32_setup_refuses_tf32(monkeypatch):
    mesh = laplacian.get_input("--size 6 --dim 2")
    got = assemble(mesh, partition_and_decompose(mesh, 2), CPU,
                   dtype=torch.float32)
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    with pytest.raises(RuntimeError, match="full float32 products"):
        geneo.setup_geneo(got.batch, GenEOOptions())
