"""The library embedding API (api.py, the PCGenEOSetup twin) of the
PyTorch port against the JAX package's api.py, on the JAX package's
tests/test_api.py problem (float64, on the CPU).

Tolerances: the batch arrays are equal (the same host construction);
the batch matvec equals A x to 1e-12; setup statistics and iteration
counts are equal; solutions agree to 1e-10 relative."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu import api as japi
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu_torch import api
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.utils.convert import batch_from_arrays

CPU = torch.device("cpu")


def _two_domain_poisson(n=12, overlap=2):
    """Hand-built 1D Poisson split into two overlapping domains, with
    PRE-WEIGHTED Neumann blocks (the reference's 1/elemMult contract)."""
    a = sp.diags([[-1.0] * (n - 1), [2.0] * n, [-1.0] * (n - 1)],
                 [-1, 0, 1]).tocsr()
    a = a + sp.eye(n) * 0.01
    half = n // 2
    g0 = np.arange(0, half + overlap)
    g1 = np.arange(half - overlap, n)
    shared = np.intersect1d(g0, g1)
    mult = np.ones(n)
    mult[shared] = 2.0

    def neu_exact(g):
        k = len(g)
        w = np.zeros((k, k))
        for ii, gi in enumerate(g):
            for jj, gj in enumerate(g):
                v = a[gi, gj]
                if v:
                    m = 2.0 if (gi in shared and gj in shared) else 1.0
                    w[ii, jj] = v / m
        return w

    inter = [[np.zeros(0, np.int64), np.searchsorted(g0, shared)],
             [np.searchsorted(g1, shared), np.zeros(0, np.int64)]]
    return n, a, [g0, g1], [neu_exact(g0), neu_exact(g1)], \
        [mult[g0], mult[g1]], inter


@pytest.mark.parametrize("dirichlet", ["derived", "global", "blocks"])
def test_make_batch_matches_jax(dirichlet):
    """Padding to 8, identity pad rows, the Dirichlet blocks derived from
    the Neumann sum, restricted from a given global matrix, or given."""
    n, a, gids, blocks, mults, _ = _two_domain_poisson()
    kw = {}
    if dirichlet == "global":
        kw["a_global"] = a
    elif dirichlet == "blocks":
        kw["a_dir_blocks"] = [a[np.ix_(g, g)].toarray() for g in gids]
    got = api.make_batch(n, gids, blocks, mults, device=CPU, **kw)
    want = japi.make_batch(n, gids, blocks, mults, dtype=jnp.float64, **kw)
    assert (got.n_dof, got.n_dom, got.n_max) == (want.n_dof, want.n_dom,
                                                 want.n_max) == (n, 2, 8)
    for name in ("gids", "mask", "mult", "a_neu", "a_dir"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    x = np.random.default_rng(0).standard_normal(n)
    np.testing.assert_allclose(got.matvec(torch.tensor(x)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)
    # utils.convert carries the JAX package's batch across unchanged
    leaves = {k: np.asarray(getattr(want, k))
              for k in ("gids", "mask", "mult", "a_neu", "a_dir")}
    carried = batch_from_arrays({**leaves, "n_dof": n}, CPU)
    for name in ("gids", "mask", "mult", "a_neu", "a_dir", "scatter_idx"):
        assert torch.equal(getattr(carried, name), getattr(got, name))


def test_make_batch_rejects_unsorted_gids():
    n, _a, gids, blocks, mults, _ = _two_domain_poisson()
    bad = [gids[0][::-1], gids[1]]
    with pytest.raises(ValueError, match="ascending"):
        api.make_batch(n, bad, blocks, mults, device=CPU)
    with pytest.raises(ValueError, match="ascending"):
        japi.make_batch(n, bad, blocks, mults)


@pytest.mark.parametrize("lvl,dls1,ksp_type,inter", [
    ("ASM,1", "cholesky", "cg", False),
    ("ASM,1", "inverse_pallas", "cg", False),
    ("SORAS,2", "cholesky", "gmres", True),
    ("RAS,E2", "cholesky", "gmres", True),
])
def test_setup_and_solve_match_jax(lvl, dls1, ksp_type, inter):
    """geneo_setup + geneo_solve from x = 1..n: the same coarse space,
    adaptive gamma (GenEO-2 with the intersections) and iterations.  The
    port's inverse_pallas runs K1 (its plain version on the CPU), the
    JAX package's plain block inverses the same product."""
    n, a, gids, blocks, mults, inters = _two_domain_poisson()
    x_true = np.arange(1.0, n + 1)
    b = a @ x_true
    jo = JaxGenEOOptions()
    jo.lvl1, jo.lvl2 = lvl.split(",")
    jo.dls1.type = "inverse" if dls1 == "inverse_pallas" else dls1
    jbatch = japi.make_batch(n, gids, blocks, mults, dtype=jnp.float64)
    jpc, jst = japi.geneo_setup(jbatch, jo, b=b,
                                intersections=inters if inter else None)
    jr = japi.geneo_solve(jbatch, b, jpc,
                          JaxKSPOptions(type=ksp_type, rtol=1e-10))
    o = GenEOOptions()
    o.lvl1, o.lvl2 = lvl.split(",")
    o.dls1.type = dls1
    batch = api.make_batch(n, gids, blocks, mults, device=CPU)
    pc, st = api.geneo_setup(batch, o, b=b,
                             intersections=inters if inter else None)
    r = api.geneo_solve(batch, b, pc, KSPOptions(type=ksp_type, rtol=1e-10))
    np.testing.assert_array_equal(st.real_dim_e, jst.real_dim_e)
    np.testing.assert_array_equal(st.nicolaides, jst.nicolaides)
    np.testing.assert_allclose(st.gamma_loc, jst.gamma_loc, rtol=1e-12)
    if inter:
        assert st.gamma_loc[0] > 1.0          # adaptive gamma computed
    assert (r.its, r.reason) == (int(jr.its), int(jr.reason))
    assert r.reason > 0
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=1e-10)
    np.testing.assert_allclose(r.x.numpy(), x_true, atol=1e-5)
    assert r.x.device == CPU and jax.devices()[0].platform == "cpu"
