"""The comparison preconditioners of the PyTorch port — ILU(0), block
Jacobi (ILU(0) or exact blocks) and the aggregation multigrid — against
the JAX package.

Applies are compared on the very same state (the JAX preconditioner's
leaves carried across by utils/convert.py) and on each package's own
setup, to 1e-12 relative (norm-wise) in float64: the same arithmetic,
summed in another order.  End to end, iteration counts and reasons are
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneo4petsc_tpu.config import DriverOptions as JaxDriverOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.ops import ilu as jax_ilu
from geneo4petsc_tpu.precond.bjacobi import setup_bjacobi as jax_setup_bjacobi
from geneo4petsc_tpu.precond.mg import setup_mg as jax_setup_mg
from geneo4petsc_tpu.solver import solve_mesh as jax_solve_mesh
from geneo4petsc_tpu_torch.assembly.assemble import assemble_global_csr
from geneo4petsc_tpu_torch.config import DriverOptions, KSPOptions
from geneo4petsc_tpu_torch.models import heat, laplacian
from geneo4petsc_tpu_torch.ops import ilu
from geneo4petsc_tpu_torch.precond.bjacobi import setup_bjacobi
from geneo4petsc_tpu_torch.precond.mg import _table_sum, setup_mg
from geneo4petsc_tpu_torch.solver import solve_mesh
from geneo4petsc_tpu_torch.utils.convert import (bjacobi_from_arrays,
                                                 mg_from_arrays)

CPU = torch.device("cpu")
TOL = 1e-12


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def operators():
    """Assembled laplacian (high contrast) and heat operators: 1024 and
    576 DOF, above mg's coarse size so the hierarchy has levels."""
    return {"laplacian": assemble_global_csr(laplacian.get_input(
                "--size 32 --dim 2 --kappa 1000. minmax")),
            "heat": assemble_global_csr(heat.get_input(
                "--size 24 --dim 2 --lbd 2. --dt 0.5"))}


def _pattern_blocks(d=3, n=14, seed=0):
    """Diagonally dominant blocks with a random symmetric pattern."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, n, n))
    keep = rng.random((d, n, n)) < 0.3
    keep = keep | keep.transpose(0, 2, 1)
    a = np.where(keep, a, 0.0)
    a[:, np.arange(n), np.arange(n)] = n + rng.random((d, n))
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_ilu0_factor_and_solve_match_jax(seed):
    a = _pattern_blocks(seed=seed)
    pattern = a != 0.0
    b = np.random.default_rng(seed + 10).standard_normal(a.shape[:2])
    ref_lu = jax_ilu.ilu0_factor(jnp.asarray(a), jnp.asarray(pattern))
    lu = ilu.ilu0_factor(torch.from_numpy(a), torch.from_numpy(pattern))
    assert _rel(lu.numpy(), ref_lu) <= TOL
    np.testing.assert_array_equal(lu.numpy() != 0, np.asarray(ref_lu) != 0)
    ref_x = jax_ilu.ilu0_solve(ref_lu, jnp.asarray(pattern), jnp.asarray(b))
    x = ilu.ilu0_solve(lu, torch.from_numpy(pattern), torch.from_numpy(b))
    assert _rel(x.numpy(), ref_x) <= TOL


def test_ilu0_of_a_full_pattern_is_lu():
    """With every entry in the pattern, ILU(0) is the exact LU."""
    a = _pattern_blocks(seed=3)
    full = np.ones_like(a, dtype=bool)
    b = np.random.default_rng(4).standard_normal(a.shape[:2])
    lu = ilu.ilu0_factor(torch.from_numpy(a), torch.from_numpy(full))
    x = ilu.ilu0_solve(lu, torch.from_numpy(full), torch.from_numpy(b))
    assert _rel(x.numpy(), np.linalg.solve(a, b[..., None])[..., 0]) <= 1e-12


def _jax_bjacobi_arrays(pc):
    return ({"factor": np.asarray(pc.factor),
             "pattern": None if pc.pattern is None else np.asarray(pc.pattern),
             "sizes": np.asarray(pc.sizes)},
            {"n_dof": pc.n_dof, "sub_type": pc.sub_type})


@pytest.mark.parametrize("n_blocks", [2, 5])
@pytest.mark.parametrize("sub_type", ["ilu", "exact"])
@pytest.mark.parametrize("op", ["laplacian", "heat"])
def test_bjacobi_matches_jax(operators, op, sub_type, n_blocks):
    a = operators[op]
    x = np.random.default_rng(n_blocks).standard_normal(a.shape[0])
    ref = jax_setup_bjacobi(a, n_blocks, dtype=jnp.float64, sub_type=sub_type)
    want = np.asarray(ref.apply(jnp.asarray(x)))
    carried = bjacobi_from_arrays(*_jax_bjacobi_arrays(ref), CPU)
    assert _rel(carried.apply(torch.from_numpy(x)).numpy(), want) <= TOL
    own = setup_bjacobi(a, n_blocks, CPU, torch.float64, sub_type=sub_type)
    assert _rel(own.factor.numpy(), np.asarray(ref.factor)) <= TOL
    assert _rel(own.apply(torch.from_numpy(x)).numpy(), want) <= TOL


def _jax_mg_arrays(pc):
    return ({"vals": [np.asarray(v) for v in pc.vals],
             "cols": [np.asarray(c) for c in pc.cols],
             "rows": [np.asarray(r) for r in pc.rows],
             "inv_diag": [np.asarray(v) for v in pc.inv_diag],
             "agg": [np.asarray(a) for a in pc.agg],
             "coarse_factor": np.asarray(pc.coarse_factor)},
            {"ns": pc.ns, "omega": pc.omega, "cycle_type": pc.cycle_type,
             "smooth_down": pc.smooth_down, "smooth_up": pc.smooth_up})


@pytest.mark.parametrize("cycle,sweeps", [("v", 1), ("w", 5), ("w", 1)])
@pytest.mark.parametrize("op", ["laplacian", "heat"])
def test_mg_matches_jax(operators, op, cycle, sweeps):
    a = operators[op]
    x = np.random.default_rng(sweeps).standard_normal(a.shape[0])
    kw = dict(cycle_type=cycle, smooth_down=sweeps, smooth_up=sweeps,
              coarse_max=64)
    ref = jax_setup_mg(a, dtype=jnp.float64, **kw)
    assert ref.n_levels >= 3
    want = np.asarray(ref.apply(jnp.asarray(x)))
    carried = mg_from_arrays(*_jax_mg_arrays(ref), CPU)
    assert _rel(carried.apply(torch.from_numpy(x)).numpy(), want) <= TOL
    own = setup_mg(a, CPU, torch.float64, **kw)
    assert own.n_levels == ref.n_levels
    for got, exp in zip(own.agg, ref.agg):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert _rel(own.apply(torch.from_numpy(x)).numpy(), want) <= TOL


def test_mg_table_sums_equal_segment_sums(operators):
    """The fixed-order table reductions give the row sums of the COO
    product and the aggregate sums of the restriction."""
    a = operators["laplacian"]
    pc = setup_mg(a, CPU, torch.float64, coarse_max=64)
    x = np.random.default_rng(0).standard_normal(a.shape[0])
    assert _rel(pc._spmv(0, torch.from_numpy(x)).numpy(), a @ x) <= 1e-14
    want = np.bincount(pc.agg[0].numpy(), weights=x)
    assert _rel(_table_sum(torch.from_numpy(x), pc.agg_table[0]).numpy(),
                want) <= 1e-14


@pytest.mark.parametrize("pc_type,mg,args", [
    ("bjacobi", None, "--size 12 --dim 2 --kappa 100. minmax"),
    ("mg", ("v", 1, 1), "--size 32 --dim 2 --kappa 100. minmax"),
    ("mg", ("w", 5, 5), "--size 32 --dim 2"),
])
def test_solve_mesh_matches_jax(pc_type, mg, args):
    def opts(drv_cls, ksp_cls):
        drv = drv_cls(add_overlap=1)
        if mg is not None:
            drv.mg_cycle_type, drv.mg_smooth_down, drv.mg_smooth_up = mg
        return dict(ksp=ksp_cls(type="cg", rtol=1e-8), driver=drv)

    ref = jax_solve_mesh(jax_laplacian.get_input(args), n_dom=4,
                         pc_type=pc_type,
                         **opts(JaxDriverOptions, JaxKSPOptions))
    got = solve_mesh(laplacian.get_input(args), CPU, n_dom=4,
                     pc_type=pc_type, **opts(DriverOptions, KSPOptions))
    assert (got.its, got.result.reason) == (ref.its, int(ref.result.reason))
    assert got.converged and got.pc_name == pc_type
    assert np.linalg.norm(got.x - ref.x) <= 1e-6 * np.linalg.norm(ref.x)
