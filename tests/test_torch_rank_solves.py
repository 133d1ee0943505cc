"""Multi-rank solves of the port through its library entry points
(``solve_structured`` / ``solve_elastic`` with ``n_devices=``) on 8 gloo
ranks, launched once for the file.

* The refinement of tests/test_torch_cli_multidevice.py's ASM,E1 case
  (laplacian 16^3, kappa 100 minmax, 2x2x2 boxes, overlap 1, CG to 1e-8)
  with a float64 inner CG: on 8 ranks, the port's single-process counts
  and the JAX package's (its single-device solve_structured), exactly.
  This is the witness for that file's float32 band: with float64 inner
  iterations the first outer pass is not at a rounding floor, and the
  counts agree on every rank count in both packages (1, 2, 4 and 8:
  tests/_torch_roundoff_witness.py ranks).
* The setup checkpoint with ranks: a structured and an elastic
  multi-rank solve run twice with one checkpoint directory; the first
  writes the setup once (rank 0), the second loads it on every rank and
  takes the same iterations.
"""

import os

import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.structured.grid import laplacian_grid as jax_grid
from geneo4petsc_tpu.structured.solve import solve_structured as jax_solve
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.parallel import multiproc, probes
from geneo4petsc_tpu_torch.structured.elastic import elastic_grid
from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
from geneo4petsc_tpu_torch.structured.solve import solve_structured

from _time_limit import wait_s

N_RANKS = 8
GRID = dict(size=16, dim=3, kappa_max=100.0, interp="minmax")

pytestmark = pytest.mark.timeout_s(600)


def _opts(lvl, cls=GenEOOptions):
    g = cls()
    g.lvl1, g.lvl2 = lvl.split(",")
    return g


def _float64_kw(**extra):
    return dict(geneo=_opts("ASM,E1"), ksp=KSPOptions(type="cg", rtol=1e-8),
                dtype=torch.float64, device="cpu", **extra)


def _checkpoint_calls(directory):
    """Small structured and elastic solves on the file's ranks, each
    twice, with one setup checkpoint directory."""
    s = ("structured", (laplacian_grid(8, dim=3, kappa_max=100.0,
                                       interp="minmax"), (2, 2, 2), 1),
         dict(geneo=_opts("ASM,1"), ksp=KSPOptions(type="cg"),
              device="cpu", n_devices=N_RANKS, checkpoint_dir=directory))
    e = ("elastic", (elastic_grid(8, kappa_max=100.0, interp="minmax",
                                  spring=100.0), (2, 2, 2), 1),
         dict(opts=_opts("ASM,0"), device="cpu", n_devices=N_RANKS,
              checkpoint_dir=directory))
    return [("solve", s, {}), ("solve", s, {}), ("solve", e, {}),
            ("solve", e, {})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, request):
    ckpt = str(tmp_path_factory.mktemp("checkpoint"))
    calls = [("solve", ("structured", (laplacian_grid(**GRID), (2, 2, 2), 1),
                        _float64_kw(n_devices=N_RANKS)), {})]
    calls += _checkpoint_calls(ckpt)
    store = tmp_path_factory.mktemp("ranks") / "store"
    got = multiproc.run_ranks(probes.batch, N_RANKS, args=(calls,),
                              init_method=f"file://{store}",
                              timeout=wait_s(request.node))
    return {"float64": got[0], "checkpoint": got[1:],
            "files": sorted(os.listdir(ckpt))}


@pytest.fixture(scope="module")
def float64_refs():
    """(inner, outer, dim_e) of the single-process port and of JAX.  The
    JAX package compiles with most XLA optimizations off (about half the
    compile time); compiled programs are dropped before and after."""
    got = solve_structured(laplacian_grid(**GRID), (2, 2, 2), 1,
                           **_float64_kw())
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        want = jax_solve(jax_grid(**GRID), (2, 2, 2), 1,
                         geneo=_opts("ASM,E1", JaxGenEOOptions),
                         ksp=JaxKSPOptions(type="cg", rtol=1e-8),
                         dtype=jnp.float64)
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
        jax.clear_caches()
    return tuple((o.refined.inner_its, o.refined.outer_its,
                  int(o.stats.real_dim_e.sum())) for o in (got, want))


def test_structured_float64_inner_counts_equal_single_and_jax(ranks,
                                                              float64_refs):
    single, jax_counts = float64_refs
    got = ranks["float64"]
    assert (got["inner"], got["outer"], got["dim_e"]) == single == jax_counts
    assert got["true_res"] <= 1e-8


@pytest.mark.parametrize("case", [0, 1], ids=["structured", "elastic"])
def test_multirank_setup_checkpoint_is_written_once_and_loaded(ranks, case):
    """Cold then warm: the warm run loads the setup and takes the cold
    run's iterations."""
    cold, warm = ranks["checkpoint"][2 * case:2 * case + 2]
    assert not cold["checkpoint_hit"] and warm["checkpoint_hit"]
    assert (cold["inner"], cold["outer"]) == (warm["inner"], warm["outer"])
    assert cold["true_res"] <= 1e-8 and warm["true_res"] <= 1e-8
    kind = ("structured", "elastic")[case]
    assert len([f for f in ranks["files"] if f.startswith(kind)]) == 1, \
        ranks["files"]
    assert all(f.endswith(".pt") for f in ranks["files"]), ranks["files"]
