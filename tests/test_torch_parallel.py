"""The port's replicated-vector generic path (parallel/sharded.py) on 8
gloo ranks against the JAX package's parallel/sharded.py on its
8-device CPU mesh (tests/test_parallel.py's problems and contracts): the
sharded matvec equals the CSR product, the sharded apply equals the
single-process one (1e-9 of its largest entry) and JAX's sharded apply,
CG and GMRES converge to x = 1..n, the CG iterations equal the
single-process ones and JAX's, and the irregular graph workload
converges.

One launch of 8 ranks runs the port's probe (parallel/probes.generic)
for the whole file (a ``file://`` rendezvous under tmp_path, a join
timeout).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.parallel.sharded import make_mesh, shard_geneo
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_partition
from geneo4petsc_tpu.precond.geneo import setup_geneo as jax_setup
from geneo4petsc_tpu_torch.parallel import multiproc, probes

from _time_limit import wait_s

N_DEV = 8
ARGS = "--size 16 --dim 2 --kappa 1000. minmax"
LEVELS = ["ASM,0", "ASM,1", "ASM,H1", "SORAS,2", "RAS,1"]

pytestmark = [pytest.mark.skipif(len(jax.devices()) < N_DEV,
                                 reason="needs 8 virtual devices"),
              pytest.mark.timeout_s(480)]


@pytest.fixture(scope="module")
def port(tmp_path_factory, request):
    store = tmp_path_factory.mktemp("ranks") / "store"
    kw = {"layout": "replicated", "rtol": 1e-10}
    calls = [("generic", (ARGS, 6, 1, LEVELS), kw),
             ("generic", (ARGS, 6, 1, ["ASM,H1"]),
              dict(kw, ksp="gmres")),
             ("generic", (ARGS, 6, 1, ["ASM,1"]),
              {"layout": "replicated", "rtol": 1e-8}),
             ("generic", ("--size 4 --level 1", 3, 1, ["RAS,1"]),
              dict(kw, model="graph"))]
    return multiproc.run_ranks(probes.batch, N_DEV, args=(calls,),
                               init_method=f"file://{store}",
                               timeout=wait_s(request.node))


@pytest.mark.parametrize("lvl", LEVELS)
def test_sharded_apply_matches_single_and_jax(port, lvl):
    got = port[0][lvl]
    np.testing.assert_allclose(got["matvec"], got["matvec_1"], atol=1e-9)
    ref = got["apply_1"]
    assert np.allclose(got["apply"], ref,
                       atol=1e-9 * max(1, np.abs(ref).max()))
    mesh = jax_laplacian.get_input(ARGS)
    d = jax_partition(mesh, 6, add_overlap=1)
    ap = jax_assemble(mesh, d)
    g = JaxGenEOOptions()
    g.lvl1, g.lvl2 = lvl.split(",")
    pc, _ = jax_setup(ap.batch, g, decomp=d)
    _mv, pa, _ = shard_geneo(pc, make_mesh(N_DEV))
    x = np.random.default_rng(0).standard_normal(mesh.n_nodes)
    want = np.asarray(pa(jnp.asarray(x)))
    assert np.allclose(got["apply"], want,
                       atol=1e-9 * max(1, np.abs(want).max()))


@pytest.mark.parametrize("case", [0, 1], ids=["cg", "gmres"])
def test_sharded_full_solve(port, case):
    got = port[case]["ASM,H1"]
    assert got["reason"] >= 0 and got["true_res"] < 1e-9


def test_sharded_iteration_counts_match_single_and_jax(port):
    got = port[2]["ASM,1"]
    mesh = jax_laplacian.get_input(ARGS)
    d = jax_partition(mesh, 6, add_overlap=1)
    ap = jax_assemble(mesh, d)
    g = JaxGenEOOptions()
    g.lvl1, g.lvl2 = "ASM", "1"
    pc, _ = jax_setup(ap.batch, g, decomp=d)
    mv, pa, _ = shard_geneo(pc, make_mesh(N_DEV))
    b = jnp.asarray(ap.a_csr @ np.arange(1.0, mesh.n_nodes + 1))
    res8 = jax.jit(lambda bb: jax_cg(mv, bb, pa, rtol=1e-8))(b)
    assert got["its"] == got["its_1"] == int(res8.its)


def test_sharded_irregular_graph(port):
    got = port[3]["RAS,1"]
    assert got["reason"] >= 0 and got["true_res"] < 1e-9
