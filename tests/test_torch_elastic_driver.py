"""solve_elastic of the PyTorch port against the JAX package on the
LOBPCG route (float64, on the CPU): the JAX package's own driver case,
size 8 with non-separable inclusions, 2x1x1 boxes, overlap 2, ASM,E1.

The local boxes hold 1536 DOFs, so GenEO-1 runs matrix-free LOBPCG with
candidate growth (8 -> 64 columns), from the JAX package's start block.
Some kept pairs stop unconverged (residuals ~1e-4 after the iteration
cap), and the level-1 solves are inexact PCG at rtol 1e-5 whose lockstep
exit rounding decides: the coarse dimensions and the outer refinement
passes are equal, the inner iteration count is held to +-1 (ROADMAP
Queue 3).  The witness that the band is rounding in the inner solve and
not a different preconditioner: the JAX package's own preconditioner,
carried into the port, lands in the same band through the port's
driver, with the same first residual to 1e-12."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.structured import elastic as jel
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov.refine import refined_solve
from geneo4petsc_tpu_torch.perf.lobpcg_start import jax_start
from geneo4petsc_tpu_torch.structured import elastic as el
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


def test_solve_elastic_nonsep_matches_jax():
    g = el.elastic_grid(8, kappa_max=1e3, nonsep=True)
    jg = jel.elastic_grid(8, kappa_max=1e3, nonsep=True)
    jo = JaxGenEOOptions()
    jo.lvl1, jo.lvl2 = "ASM", "E1"
    want = jel.solve_elastic(jg, (2, 1, 1), 2, jo, tol=1e-8,
                             dtype=jnp.float64)
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "ASM", "E1"
    got = el.solve_elastic(g, (2, 1, 1), 2, o, tol=1e-8, device=CPU,
                           lobpcg_start=jax_start)
    assert got.pc.z.dtype == torch.float64 and got.pc.z.device == CPU
    assert got.converged and want.converged and got.true_res <= 1e-8
    np.testing.assert_array_equal(got.stats.real_dim_e,
                                  want.stats.real_dim_e)
    np.testing.assert_array_equal(got.stats.nicolaides,
                                  want.stats.nicolaides)
    assert got.refined.outer_its == want.refined.outer_its
    assert abs(got.refined.inner_its - want.refined.inner_its) <= 1
    x_true = np.arange(1.0, g.n_dof + 1)
    np.testing.assert_allclose(got.x, x_true, rtol=0,
                               atol=1e-5 * x_true.max())

    # the witness: the JAX preconditioner in the port's driver
    tp = elastic_from_tree(jax.tree_util.tree_map(np.asarray, want.pc), CPU)
    b = want.b
    r = refined_solve(b, lambda x: b - g.matvec(x), el.make_elastic_inner(tp),
                      tol=1e-8, x0=tp.x0.numpy())
    assert r.outer_its == want.refined.outer_its
    assert abs(r.inner_its - want.refined.inner_its) <= 1
    assert abs(r.history[0] / want.refined.history[0] - 1.0) <= 1e-12
    assert r.converged and r.true_res <= 1e-8
