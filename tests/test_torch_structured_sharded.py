"""The port's multi-rank structured and elastic backends
(structured/sharded.py: z-slab vectors, contiguous domain chunks, the
plane plan) on gloo ranks against the JAX package's shard_structured /
shard_elastic on its 8-device CPU mesh (tests/conftest.py), with
tests/test_structured_sharded.py's configurations and contracts.

On the same seeded vector the port's rank-split matvec equals JAX's
sharded one to 1e-12 and the apply to 1e-10 (the elastic apply, whose
level-1 solve is an inexact PCG, to 1e-7: the two packages' setups
agree to 6e-9 there), and each equals the port's own single process
(the elastic apply to JAX's 3e-5).  The float64 CG takes JAX's sharded
CG's iterations on the same rank counts.  JAX's own 8-device count test
runs RAS,1 to rtol 1e-10, where CG stagnates and both packages stop at
their iteration cap; its count here is taken to 1e-8, where it converges.
One more case beyond JAX's tests: 4x4x4 boxes on 8 ranks, where a rank's
domains do not fill whole z-layers and its window spans layers it shares.

Each launch runs the port's probe (parallel/probes.structured) with a
``file://`` rendezvous under tmp_path and a join timeout.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.structured.decompose import \
    StructuredDecomposition as JaxDecomposition
from geneo4petsc_tpu.structured.elastic import elastic_grid as jax_egrid
from geneo4petsc_tpu.structured.elastic import setup_elastic as jax_esetup
from geneo4petsc_tpu.structured.geneo import setup_structured as jax_setup
from geneo4petsc_tpu.structured.grid import laplacian_grid as jax_grid
from geneo4petsc_tpu.structured.sharded import (make_mesh, shard_elastic,
                                                shard_structured)
from geneo4petsc_tpu_torch.parallel import multiproc, probes

from _time_limit import wait_s

# (ranks, kind, size, boxes, level, CG rtol); the probe's other settings
# are tests/test_structured_sharded.py's
CASES = {
    "two": (2, "laplacian", 16, (2, 2, 2), "RAS,1", 1e-10),
    "eight": (8, "laplacian", 16, (2, 2, 8), "RAS,1", 1e-8),
    "h1": (8, "laplacian", 16, (2, 2, 8), "RAS,H1", 1e-8),
    "elastic": (8, "elastic", 8, (2, 2, 2), "RAS,1", 1e-8),
    "layers": (8, "laplacian", 16, (4, 4, 4), "ASM,1", 1e-10),
}

pytestmark = [pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="needs the 8-device CPU mesh"),
              pytest.mark.timeout_s(600)]


def _probe_call(name):
    _n, kind, size, boxes, lvl, rtol = CASES[name]
    kw = {"rtol": rtol}
    if kind == "elastic":
        kw.update(cut=8, flexible=True)
    return ("structured", (kind, size, boxes, 1, [lvl]), kw)


@pytest.fixture(scope="module")
def port(tmp_path_factory, request):
    """Every case of the file from one launch per rank count."""
    out = {}
    counts = sorted({c[0] for c in CASES.values()})
    wait = wait_s(request.node, waits=len(counts))
    for n in counts:
        names = [k for k, c in CASES.items() if c[0] == n]
        store = tmp_path_factory.mktemp("ranks") / "store"
        got = multiproc.run_ranks(
            probes.batch, n, args=([_probe_call(k) for k in names],),
            init_method=f"file://{store}", timeout=wait)
        out.update({k: g[CASES[k][4]] for k, g in zip(names, got)})
    return out


@pytest.fixture(scope="module")
def ref():
    """JAX's sharded operators on the seeded vector of the port's probe
    and its sharded CG's iterations, compiled with most XLA
    optimizations off (about half the compile time); compiled programs
    are dropped before and after."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return {k: _jax_case(*c) for k, c in CASES.items()}
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
        jax.clear_caches()


def _jax_case(n_dev, kind, size, boxes, lvl, rtol):
    opts = JaxGenEOOptions()
    opts.lvl1, opts.lvl2 = lvl.split(",")
    if kind == "elastic":
        opts.cut = 8
        grid = jax_egrid(size, kappa_max=100.0, interp="minmax",
                         spring=100.0)
        pc, _ = jax_esetup(grid, boxes, 1, opts, dtype=jnp.float64)
        shard = shard_elastic
    else:
        grid = jax_grid(size, dim=3, kappa_max=1000.0, interp="minmax")
        pc, _ = jax_setup(JaxDecomposition(grid, boxes, 1), opts,
                          dtype=jnp.float64)
        shard = shard_structured
    mv, ap, _pc, shard_vec = shard(pc, make_mesh(n_dev))
    _xt, b = grid.manufactured_rhs()
    x = np.random.default_rng(0).standard_normal(b.shape[0])
    res = jax_cg(mv, shard_vec(np.asarray(b)), ap, rtol=rtol, max_it=300,
                 flexible=kind == "elastic")
    return {"matvec": np.asarray(mv(shard_vec(x)), np.float64),
            "apply": np.asarray(ap(shard_vec(x)), np.float64),
            "its": int(res.its)}


def _operators(got, want=None, apply_rtol=1e-10, apply_atol=1e-9):
    """The rank-split operators against the port's single process and,
    given ``want``, against JAX's sharded ones."""
    np.testing.assert_allclose(got["matvec"], got["matvec_1"], rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(got["apply"], got["apply_1"],
                               rtol=apply_rtol, atol=apply_atol)
    if want is not None:
        np.testing.assert_allclose(got["matvec"], want["matvec"],
                                   rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(got["apply"], want["apply"], rtol=1e-10,
                                   atol=1e-9)


def test_sharded_apply_matches_single_process_2_ranks(port, ref):
    _operators(port["two"], ref["two"])


def test_sharded_apply_matches_single_process_8_ranks(port, ref):
    _operators(port["eight"], ref["eight"])


@pytest.mark.parametrize("case", ["two", "eight"])
def test_sharded_cg_iteration_count_parity(port, ref, case):
    got = port[case]
    assert got["its"] == got["its_1"] == ref[case]["its"] < 300
    assert got["true_res"] < 1e-7


def test_sharded_geneo2level_converges(port, ref):
    got = port["h1"]
    _operators(got, ref["h1"])
    assert got["its"] == ref["h1"]["its"] < 300
    assert got["true_res"] < 1e-7


def test_elastic_sharded_apply_and_iterations(port, ref):
    got, want = port["elastic"], ref["elastic"]
    _operators(got, apply_rtol=3e-5, apply_atol=1e-4)
    np.testing.assert_allclose(got["matvec"], want["matvec"], rtol=1e-12,
                               atol=1e-9)
    scale = np.abs(want["apply"]).max()
    assert np.abs(got["apply"] - want["apply"]).max() <= 1e-7 * scale
    assert got["its"] == got["its_1"] == want["its"] < 300
    assert got["true_res"] < 1e-7


def test_layers_split_between_ranks(port, ref):
    """gz = 4 on 8 ranks: every rank holds half a z-layer of domains."""
    got = port["layers"]
    _operators(got, ref["layers"])
    assert got["its"] == got["its_1"] == ref["layers"]["its"]


def test_misaligned_mesh_is_refused():
    from geneo4petsc_tpu_torch.structured.sharded import need_divisible
    with pytest.raises(ValueError, match="must divide the mesh size 8"):
        need_divisible(15, 3, 8)
