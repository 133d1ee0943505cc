"""The heat, graph and elasticity generators, the brick partition of a
structured grid and the nodal fast decomposition of the PyTorch port
against the JAX package: identical arrays (host NumPy code on both
sides, so no tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.models import elasticity as jax_elasticity
from geneo4petsc_tpu.models import graph as jax_graph
from geneo4petsc_tpu.models import heat as jax_heat
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.partition import decompose as jax_decompose
from geneo4petsc_tpu.partition import kway as jax_kway
from geneo4petsc_tpu_torch.assembly.assemble import assemble
from geneo4petsc_tpu_torch.io.plugin import get_lib_input
from geneo4petsc_tpu_torch.models import elasticity, graph, heat, laplacian
from geneo4petsc_tpu_torch.partition import decompose, kway

# tst/iters.py's GENERATOR_ARGS at its SIZES (heat 10, graph 16), and the
# cases of tests/test_generators.py and tests/test_elasticity.py
CASES = [
    (heat, jax_heat, "--size 10 --weakScaling 1 --dim 2 --lbd 2. --dt 0.5"),
    (heat, jax_heat, "--size 5 --dim 2 --inpEps 0.001 --lbd 2. --dt 0.5"),
    (heat, jax_heat, "--size 4 --dim 3 --kappa 100. minmax"),
    (graph, jax_graph, "--size 16 --weakScaling 1"),
    (graph, jax_graph, "--size 4 --level 1"),
    (graph, jax_graph, "--size 4 --level 0 --noGround --inpEps 0.01"),
    (graph, jax_graph, "--size 9 --level 3"),
    (elasticity, jax_elasticity, "--size 10 --nu 0.3"),
    (elasticity, jax_elasticity, "--size 12 --nu 0.3 --kappa 1000. minmax"),
    (elasticity, jax_elasticity, "--size 5 --dim 3 --kappa 100. minmax"),
    (elasticity, jax_elasticity, "--size 4 --dim 3 --nu 0.45 --spring 10."),
]


def _assert_same_mesh(got, ref):
    assert got.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(got.elem_ptr, ref.elem_ptr)
    np.testing.assert_array_equal(got.elem_idx, ref.elem_idx)
    assert len(got.elem_mats) == len(ref.elem_mats)
    for a, b in zip(got.elem_mats, ref.elem_mats):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mod,jax_mod,args", CASES,
                         ids=[f"{m.__name__.split('.')[-1]}:{a}"
                              for m, _, a in CASES])
def test_generator_meshes_identical(mod, jax_mod, args):
    _assert_same_mesh(mod.get_input(args), jax_mod.get_input(args))


@pytest.mark.parametrize("name", ["heat", "graph", "elasticity"])
def test_generators_are_registered(name):
    args = {"heat": "--size#5#--dim#2", "graph": "--size#4#--level#1",
            "elasticity": "--size#4"}[name]
    mod = {"heat": jax_heat, "graph": jax_graph,
           "elasticity": jax_elasticity}[name]
    _assert_same_mesh(get_lib_input(name, args),
                      mod.get_input(args.replace("#", " ")))


def test_elasticity_rejects_bad_dim():
    with pytest.raises(ValueError, match="--dim must be 2 or 3"):
        elasticity.get_input("--size 4 --dim 1")


@pytest.mark.parametrize("shape,grid", [((8, 8), (2, 2)), ((10, 7), (3, 2)),
                                        ((6, 5, 4), (2, 2, 2)),
                                        ((512, 512), (32, 32))])
def test_structured_grid_partition_identical(shape, grid):
    got = kway.partition_structured_grid(shape, grid)
    np.testing.assert_array_equal(
        got, jax_kway.partition_structured_grid(shape, grid))
    assert sorted(np.unique(got)) == list(range(int(np.prod(grid))))


def _assert_same_decomposition(got, ref):
    assert (got.n_dom, got.metis_dual, got.add_overlap) == \
        (ref.n_dom, ref.metis_dual, ref.add_overlap)
    for name in ("elem_doms", "dom_nodes"):
        for a, b in zip(getattr(got, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b)
    for name in ("node_mult", "elem_mult", "node_part"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    for row_g, row_r in zip(got.intersections, ref.intersections):
        for a, b in zip(row_g, row_r):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inter", [False, True], ids=["plain", "intersect"])
@pytest.mark.parametrize("gen,args,shape,grid", [
    ("laplacian", "--size 12 --dim 2 --kappa 100. minmax", (12, 12), (3, 2)),
    ("heat", "--size 6 --dim 3", (6, 6, 6), (2, 2, 1)),
])
def test_nodal_fast_decomposition_identical(gen, args, shape, grid, inter):
    mods = {"laplacian": (laplacian, jax_laplacian), "heat": (heat, jax_heat)}
    mod, jax_mod = mods[gen]
    mesh, ref_mesh = mod.get_input(args), jax_mod.get_input(args)
    n_dom = int(np.prod(grid))
    part = kway.partition_structured_grid(shape, grid)
    got = decompose.decompose_nodal_fast(mesh, part, n_dom,
                                         compute_intersections=inter)
    ref = jax_decompose.decompose_nodal_fast(ref_mesh, part, n_dom,
                                             compute_intersections=inter)
    _assert_same_decomposition(got, ref)
    if inter:
        np.testing.assert_array_equal(got.adjacency(), ref.adjacency())


def test_nodal_fast_assembly_identical():
    """The large configuration's host chain at a small size: brick
    partition, nodal fast decomposition, float32 assembly."""
    args = "--size 16 --dim 2 --kappa 10000. minmax"
    mesh, ref_mesh = laplacian.get_input(args), jax_laplacian.get_input(args)
    part = kway.partition_structured_grid((16, 16), (4, 4))
    got = assemble(mesh, decompose.decompose_nodal_fast(mesh, part, 16),
                   torch.device("cpu"), dtype=torch.float32)
    ref = jax_assemble(ref_mesh, jax_decompose.decompose_nodal_fast(
        ref_mesh, part, 16), dtype=jnp.float32)
    for name in ("gids", "mask", "mult", "a_neu", "a_dir"):
        np.testing.assert_array_equal(
            getattr(got.batch, name).numpy(),
            np.asarray(getattr(ref.batch, name)))
    assert got.batch.a_neu.dtype == torch.float32
    assert (got.a_csr != ref.a_csr).nnz == 0
