"""Block-layout iteration of the port (structured/blockmode.py) against
the port's global layout and the JAX package's BlockGenEO
(tests/test_blockmode.py).

The block-major loop is the same preconditioned operator as the global
one, only the vector ordering changes.  Contracts: on the CPU the
port's block operators (matvec, apply, apply_q) equal its global-layout
ones bit for bit in float32 and float64; they agree with JAX's block
operators to 1e-12 (float64) / 1e-6 (float32) of their largest entry;
no global <-> brick permute (halo.halo_gather / halo_scatter_add, the
only callers of the 6-D permute) runs inside an apply or a matvec; the
solves meet test_blockmode.py's contracts against the port's global
layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.structured import blockmode as jblockmode
from geneo4petsc_tpu.structured.decompose import \
    StructuredDecomposition as JaxSD
from geneo4petsc_tpu.structured.geneo import setup_structured as jax_setup
from geneo4petsc_tpu.structured.grid import laplacian_grid as jax_grid
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.structured import blockmode, halo
from geneo4petsc_tpu_torch.structured.decompose import \
    StructuredDecomposition
from geneo4petsc_tpu_torch.structured.geneo import setup_structured
from geneo4petsc_tpu_torch.structured.grid import heat_grid, laplacian_grid
from geneo4petsc_tpu_torch.structured.solve import solve_structured

LEVELS = [("ASM", "0"), ("ASM", "E1"), ("RAS", "1"), ("SORAS", "H2")]


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """Compile the JAX reference with most XLA optimizations off, as the
    other structured parity files do (compiled programs dropped before
    and after)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
    jax.clear_caches()


def jax_start(d, n, k, dtype):
    """The JAX package's LOBPCG start block (structured/geneo.py)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, n, k),
                                      jdt))


def _opts(cls, lvl1, lvl2):
    o = cls()
    o.lvl1, o.lvl2, o.cut = lvl1, lvl2, 2
    return o


def _port(lvl1, lvl2, dtype):
    grid = laplacian_grid(16, dim=3, kappa_max=1e4, interp="minmax")
    sd = StructuredDecomposition(grid, (2, 2, 2), 2)
    pc, _ = setup_structured(sd, _opts(GenEOOptions, lvl1, lvl2),
                             dtype=dtype, device="cpu",
                             lobpcg_start=jax_start)
    return grid, pc, blockmode.build_block_mode(pc, sd, dtype, "cpu")


def _x(n, dtype):
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal(n)).to(dtype)


@pytest.fixture
def count_permutes(monkeypatch):
    """Counts the calls of the two halo functions that carry the global
    <-> brick permute."""
    calls = []
    for name in ("halo_gather", "halo_scatter_add"):
        fn = getattr(halo, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(halo, name, spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lvl1,lvl2", LEVELS)
def test_block_operators_equal_global_bits(lvl1, lvl2, dtype,
                                           count_permutes):
    grid, pc, blk = _port(lvl1, lvl2, dtype)
    x = _x(grid.n_nodes, dtype)
    xb = blk.to_block(x)
    assert torch.equal(blk.from_block(xb), x)     # a pure permutation
    count_permutes.clear()
    mv, ap = blk.matvec(xb), blk.apply(xb)
    q = blk.apply_q(xb) if pc.lvl2 else None
    assert count_permutes == []                   # none inside an apply
    assert torch.equal(blk.from_block(mv), pc.matvec(x))
    assert torch.equal(blk.from_block(ap), pc.apply(x))
    if q is not None:
        assert torch.equal(blk.from_block(q), pc.apply_q(x))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("lvl1,lvl2", LEVELS)
def test_block_operators_match_jax(lvl1, lvl2, dtype, tol):
    grid, pc, blk = _port(lvl1, lvl2, dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jg = jax_grid(16, dim=3, kappa_max=1e4, interp="minmax")
    jsd = JaxSD(jg, (2, 2, 2), 2)
    jpc, _ = jax_setup(jsd, _opts(JaxGenEOOptions, lvl1, lvl2), dtype=jdt)
    jblk = jblockmode.build_block_mode(jpc, jsd, dtype=jdt)
    x = _x(grid.n_nodes, dtype)
    xb, jxb = blk.to_block(x), jblk.to_block(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb))
    names = ("matvec", "apply")
    if dtype == torch.float32 and lvl2 == "H2":
        # the two packages' float32 LOBPCG of the H2 gamma pencil land
        # 5e-5 apart (a setup difference, not a layout one): this case
        # holds its apply to JAX's in float64 only
        names = ("matvec",)
    for name in names:
        got = blk.from_block(getattr(blk, name)(xb)).numpy()
        want = np.asarray(jblk.from_block(getattr(jblk, name)(jxb)))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= tol * scale, name


def test_fold_is_the_adjoint_of_extend_and_matches_jax():
    rng = np.random.default_rng(1)
    pad = (2, 2, 1)
    core = rng.standard_normal((3, 2, 4, 6, 7, 5))
    xe = blockmode.extend_blocks(torch.from_numpy(core), pad)
    np.testing.assert_array_equal(
        xe.numpy(), np.asarray(jblockmode.extend_blocks(jnp.asarray(core),
                                                        pad)))
    w = rng.standard_normal(tuple(xe.shape))
    got = blockmode.fold_blocks(torch.from_numpy(w), pad).numpy()
    want = np.asarray(jblockmode.fold_blocks(jnp.asarray(w), pad))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    lhs = float((xe.numpy() * w).sum())
    assert abs(lhs - float((core * got).sum())) <= 1e-10 * abs(lhs)


def test_block_layout_refuses_wide_overlap():
    grid = laplacian_grid(8, dim=3)
    sd = StructuredDecomposition(grid, (2, 2, 2), 3)
    pc, _ = setup_structured(sd, _opts(GenEOOptions, "ASM", "0"),
                             dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="inner >= 2\\*overlap"):
        blockmode.build_block_mode(pc, sd, torch.float64, "cpu")


@pytest.mark.parametrize("lvl1,lvl2,workload", [
    ("ASM", "E1", "laplacian"),
    ("SORAS", "2", "laplacian"),
    ("ASM", "E1", "heat"),
])
def test_solve_meets_the_jax_contracts(lvl1, lvl2, workload):
    """test_blockmode.py's contracts, block layout against the port's
    global layout: converged to a true 1e-8, the same coarse space,
    outer passes within 1, inner iterations within 2 x + 30, solutions
    within 1e-5 n."""
    mk = laplacian_grid if workload == "laplacian" else heat_grid
    extra = {} if workload == "laplacian" else {"lbd": 1.0, "dt": 0.1}
    grid = mk(16, dim=3, kappa_max=1e4, interp="minmax", **extra)
    opts = _opts(GenEOOptions, lvl1, lvl2)
    opts.optim = 1.0
    kw = dict(geneo=opts, ksp=KSPOptions(type="cg"), tol=1e-8, device="cpu",
              lobpcg_start=jax_start)
    ref = solve_structured(grid, (2,) * 3, 2, block_layout=False, **kw)
    out = solve_structured(grid, (2,) * 3, 2, block_layout=True, **kw)
    assert out.converged and out.true_res <= 1.01e-8
    np.testing.assert_array_equal(out.stats.real_dim_e, ref.stats.real_dim_e)
    assert abs(out.refined.outer_its - ref.refined.outer_its) <= 1
    assert out.refined.inner_its <= ref.refined.inner_its * 2 + 30
    np.testing.assert_allclose(out.x, ref.x, rtol=0,
                               atol=1e-5 * grid.n_nodes)
