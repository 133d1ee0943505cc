"""Witnesses for two parity bands of tests/test_torch_lobpcg_generic.py
(ROADMAP Queue 3), with JAX on the CPU:

    python tests/_torch_roundoff_witness.py [--quick]

1. prune: SORAS,2 with ``-els2_type lobpcg`` and no cut, laplacian
   ``--size S --dim 2 --kappa 1000. minmax``, 4 domains, overlap 1, both
   packages from the same start block ``jax.random.normal(PRNGKey(key))``
   for keys 0-3 at S = 16 and key 0 at S = 12, 20, 24: per-domain real
   dim_e, pruned columns, CG iterations to 1e-8, and the smallest pivots
   of the pivoted Cholesky of E beside the prune floor.
2. float32 refinement: ``test_float32_refined_solve_matches_jax`` at
   sizes 16 and 32 with torch's intra-op threads 1, 2, 4 and 8: the
   inner iterations of each package.

``--quick`` compiles the JAX side with ``jax_disable_most_optimizations``
as the test file does (which changes JAX's start block and arithmetic in
the last bits)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
if "--quick" in sys.argv:
    jax.config.update("jax_disable_most_optimizations", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.linalg.lapack import dpstrf  # noqa: E402

import geneo4petsc_tpu.ops.lobpcg as jax_lobpcg  # noqa: E402
import test_torch_lobpcg_generic as t  # noqa: E402
from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble  # noqa: E402
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions  # noqa: E402
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg_solve  # noqa: E402
from geneo4petsc_tpu.models import laplacian as jax_laplacian  # noqa: E402
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_partition_and_decompose  # noqa: E402
from geneo4petsc_tpu.precond import geneo as jax_geneo  # noqa: E402
from geneo4petsc_tpu_torch.assembly.assemble import assemble  # noqa: E402
from geneo4petsc_tpu_torch.config import GenEOOptions  # noqa: E402
from geneo4petsc_tpu_torch.krylov.cg import cg_solve  # noqa: E402
from geneo4petsc_tpu_torch.models import laplacian  # noqa: E402
from geneo4petsc_tpu_torch.partition.decompose import \
    partition_and_decompose  # noqa: E402
from geneo4petsc_tpu_torch.precond import geneo  # noqa: E402

CPU = torch.device("cpu")


def _spy_prune(module, seen, tag):
    """Record the smallest pivots of E's pivoted Cholesky and the floor."""
    prune = module.prune_dependent_columns

    def spy(e, dtype):
        tol = e.shape[0] * np.finfo(dtype).eps * float(np.diagonal(e).max())
        c, _piv, rank, _ = dpstrf(np.array(e), lower=1, tol=tol)
        pivots = np.sort(np.diagonal(c)[:int(rank)] ** 2)[:2]
        seen[tag] = f"rank {int(rank)}/{e.shape[0]}, smallest pivots " \
                    f"{pivots[0]:.3e} {pivots[1]:.3e}, floor {tol:.3e}"
        return prune(e, dtype)

    module.prune_dependent_columns = spy


def prune(size: int, key: int) -> None:
    args = f"--size {size} --dim 2 --kappa 1000. minmax"
    ref_mesh, mesh = jax_laplacian.get_input(args), laplacian.get_input(args)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    g, jg = GenEOOptions(), JaxGenEOOptions()
    for o in (g, jg):
        o.lvl1, o.lvl2, o.cut = "SORAS", "2", 0
        o.els2.type = "lobpcg"
    seen = {}
    _spy_prune(jax_geneo, seen, "jax")
    _spy_prune(geneo, seen, "port")
    prng = jax.random.PRNGKey
    # JAX's draw is traced into its compiled setup: drop the programs
    # compiled for an earlier key
    jax.clear_caches()
    jax_lobpcg.jax.random.PRNGKey = lambda _seed: prng(key)
    try:
        ref_pc, ref_st = jax_geneo.setup_geneo(ref.batch, jg,
                                               decomp=ref.decomp,
                                               a_csr=ref.a_csr)
    finally:
        jax_lobpcg.jax.random.PRNGKey = prng

    def start(d, n, k, dtype):
        return torch.from_numpy(np.array(jax.random.normal(
            prng(key), (d, n, k), jnp.float64)))

    geneo.default_start = start
    pc, st = geneo.setup_geneo(got.batch, g, decomp=got.decomp,
                               a_csr=got.a_csr)
    rhs = np.random.default_rng(1).standard_normal(got.n_dof)
    ref_res = jax_cg_solve(ref_pc.batch.matvec, jnp.asarray(rhs),
                           ref_pc.apply, rtol=1e-8)
    res = cg_solve(got.batch.matvec, torch.from_numpy(rhs), pc.apply,
                   rtol=1e-8)
    print(f"prune size {size} key {key}: raw dim_e equal "
          f"{np.array_equal(st.raw_dim_e, ref_st.raw_dim_e)}; real dim_e "
          f"JAX {ref_st.real_dim_e.tolist()} port {st.real_dim_e.tolist()}; "
          f"pruned JAX {ref_st.e_pruned} port {st.e_pruned}; CG its JAX "
          f"{int(ref_res.its)} port {res.its}", flush=True)
    for tag in ("jax", "port"):
        print(f"    {tag}: {seen[tag]}", flush=True)


def float32_refinement() -> None:
    counts = {}
    solve, jax_solve = t.refined_solve, t.jax_refined_solve

    def spy(*a, **kw):
        r = solve(*a, **kw)
        counts["port"] = r.inner_its
        return r

    def jax_spy(*a, **kw):
        r = jax_solve(*a, **kw)
        counts["jax"] = r.inner_its
        return r

    t.refined_solve, t.jax_refined_solve = spy, jax_spy
    for size in (16, 32):
        for threads in (1, 2, 4, 8):
            torch.set_num_threads(threads)
            try:
                t.test_float32_refined_solve_matches_jax(size)
                held = "held"
            except AssertionError:
                held = "NOT held"
            print(f"float32 refinement size {size}, torch threads "
                  f"{threads}: inner JAX {counts['jax']} port "
                  f"{counts['port']} (band +-3 {held})", flush=True)


if __name__ == "__main__":
    for key in range(4):
        prune(16, key)
    for size in (12, 20, 24):
        prune(size, 0)
    float32_refinement()
