"""ROADMAP Queue 3: SORAS,E2 with ``-els2_type lobpcg`` under CG on
laplacian ``--size 32 --dim 2 --kappa 10000. minmax``, 8 domains,
overlap 1, rtol 1e-8 — JAX converges in 14 iterations; the port's CG
count under its own PC moves with torch's thread count during the set-up
(1 thread: 12, converged; 2: 344, converged; 4: 13 and 8: 10, both
DIVERGED_INDEFINITE_PC).

The witness (tests/_torch_roundoff_witness.py, ``soras``): JAX's own
preconditioner carried into the port (utils.convert.pc_from_arrays)
takes JAX's 14 through the port's CG, so the CG is not at fault; the two
setups keep the same per-domain dim_e and eigenvalues to 1e-13, but
their LOBPCG eigenvectors stop at residuals near 1e-4, where the two
packages' arithmetic (and the port's summation order on another thread
count) leaves vectors 1e-3 apart.  CG under the non-symmetric SORAS
preconditioner turns on that: JAX itself ends on DIVERGED_INDEFINITE_PC
for 3 of 6 start keys, and for all 3 tried once its eigenvectors
converge further (400 iterations, tolerance 1e-9), at 10-13 iterations
as the port does.  A rounding band, not a port fault; these tests pin
it: JAX's PC through both CGs gives 14, the port's PC from JAX's start
block, set up on one torch thread, gives the recorded 12, and GMRES (the
reference's Krylov method for SORAS) takes the same iterations with
either package's PC."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.krylov.gmres import gmres_solve as jax_gmres
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_partition
from geneo4petsc_tpu.precond import geneo as jax_geneo
from geneo4petsc_tpu_torch.assembly.assemble import assemble
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov import common as cm
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.krylov.gmres import gmres_solve
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.partition.decompose import partition_and_decompose
from geneo4petsc_tpu_torch.precond import geneo
from geneo4petsc_tpu_torch.utils.convert import pc_from_arrays

from _threads import torch_threads

ARGS = "--size 32 --dim 2 --kappa 10000. minmax"
CPU = torch.device("cpu")
# torch intra-op threads of the port's set-up: the band end moves with
# the summation order of its CPU kernels; one thread is the same order
# alone and beside other workers
PINNED_THREADS = 1


def jax_start(d, n, k, dtype):
    """JAX's LOBPCG start block (the draw inside its batched_lobpcg)."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (d, n, k), jdt)))


def _opts(cls):
    g = cls()
    g.lvl1, g.lvl2 = "SORAS", "E2"
    g.els2.type = "lobpcg"
    return g


def _leaf(a):
    return None if a is None else np.asarray(a)


@pytest.fixture(scope="module")
def both():
    ref_mesh = jax_laplacian.get_input(ARGS)
    ref = jax_assemble(ref_mesh, jax_partition(ref_mesh, 8, add_overlap=1))
    mesh = laplacian.get_input(ARGS)
    got = assemble(mesh, partition_and_decompose(mesh, 8, add_overlap=1),
                   CPU)
    b = np.asarray(ref.a_csr @ np.arange(1.0, mesh.n_nodes + 1))
    jpc, jst = jax_geneo.setup_geneo(ref.batch, _opts(JaxGenEOOptions),
                                     b=jnp.asarray(b), decomp=ref.decomp,
                                     a_csr=ref.a_csr)
    start = geneo.default_start
    geneo.default_start = jax_start
    try:
        with torch_threads(PINNED_THREADS):
            pc, st = geneo.setup_geneo(got.batch, _opts(GenEOOptions),
                                       b=torch.from_numpy(b),
                                       decomp=got.decomp, a_csr=got.a_csr)
    finally:
        geneo.default_start = start
    bt = jpc.batch
    l1 = jpc.l1_factor
    d = {"gids": _leaf(bt.gids), "mask": _leaf(bt.mask),
         "mult": _leaf(bt.mult), "a_neu": _leaf(bt.a_neu),
         "a_dir": _leaf(bt.a_dir), "n_dof": bt.n_dof,
         "l1_factor": tuple(map(_leaf, l1)) if isinstance(l1, tuple)
         else _leaf(l1), "pou": _leaf(jpc.pou), "z_loc": _leaf(jpc.z_loc),
         "colids": _leaf(jpc.colids), "e_evecs": _leaf(jpc.e_evecs),
         "e_eig_inv": _leaf(jpc.e_eig_inv), "x0": _leaf(jpc.x0)}
    meta = {k: getattr(jpc, k) for k in ("lvl1", "lvl2", "hybrid",
                                         "eff_hybrid", "dim_e", "k_max",
                                         "l1_kind")}
    return b, jpc, jst, pc, st, pc_from_arrays(d, meta, CPU)


def test_same_coarse_space_dimensions(both):
    _b, _jpc, jst, _pc, st, _conv = both
    np.testing.assert_array_equal(st.real_dim_e, jst.real_dim_e)


def test_jax_pc_takes_jax_count_through_both_cgs(both):
    b, jpc, _jst, _pc, _st, conv = both
    ref = jax_cg(jpc.batch.matvec, jnp.asarray(b), jpc.apply, x0=jpc.x0,
                 rtol=1e-8)
    got = cg_solve(conv.batch.matvec, torch.from_numpy(b), conv.apply,
                   x0=conv.x0, rtol=1e-8)
    assert (got.its, got.reason) == (int(ref.its), int(ref.reason)) \
        == (14, cm.CONVERGED_RTOL)


def test_port_pc_under_cg_is_the_recorded_band_end(both):
    b, _jpc, _jst, pc, _st, _conv = both
    got = cg_solve(pc.batch.matvec, torch.from_numpy(b), pc.apply, x0=pc.x0,
                   rtol=1e-8)
    assert (got.its, got.reason) == (12, cm.CONVERGED_RTOL)


def test_gmres_takes_the_same_iterations_with_either_pc(both):
    b, jpc, _jst, pc, _st, conv = both
    ref = jax_gmres(jpc.batch.matvec, jnp.asarray(b), jpc.apply, x0=jpc.x0,
                    rtol=1e-8)
    for p in (pc, conv):
        got = gmres_solve(p.batch.matvec, torch.from_numpy(b), p.apply,
                          x0=p.x0, rtol=1e-8)
        assert got.reason > 0 and got.its == int(ref.its)
