"""Host input, partitioning, decomposition and assembly of the PyTorch port
against the JAX package: identical arrays, and the port's MatIS matvec
against the assembled operator."""

import numpy as np
import pytest
import torch

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.partition import kway as jax_kway
from geneo4petsc_tpu.partition.decompose import (
    partition_and_decompose as jax_partition_and_decompose)
from geneo4petsc_tpu_torch.assembly.assemble import assemble, scatter_table
from geneo4petsc_tpu_torch.io.plugin import get_lib_input
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.partition import kway
from geneo4petsc_tpu_torch.partition.decompose import partition_and_decompose

CPU = torch.device("cpu")
GEN_ARGS = "--size 12 --dim 2 --kappa 100. minmax"


def _meshes(args=GEN_ARGS):
    return jax_laplacian.get_input(args), laplacian.get_input(args)


@pytest.mark.parametrize("args", [GEN_ARGS, "--size 5 --dim 3",
                                  "--size 9 --dim 1 --kappa 10. quad"])
def test_generator_meshes_identical(args):
    ref, got = _meshes(args)
    assert got.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(got.elem_ptr, ref.elem_ptr)
    np.testing.assert_array_equal(got.elem_idx, ref.elem_idx)
    assert len(got.elem_mats) == len(ref.elem_mats)
    for a, b in zip(got.elem_mats, ref.elem_mats):
        np.testing.assert_array_equal(a, b)


def test_plugin_expands_hash_args():
    mesh = get_lib_input("laplacian", "--size#6#--dim#2")
    ref = jax_laplacian.get_input("--size 6 --dim 2")
    np.testing.assert_array_equal(mesh.elem_idx, ref.elem_idx)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "nodal"])
def test_python_partitioner_identical(dual):
    ref_mesh, mesh = _meshes()
    got = kway.partition_mesh_py(mesh, 5, dual)
    want = jax_kway.partition_mesh_py(ref_mesh, 5, dual)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dual,overlap", [(True, 0), (True, 1), (False, 1)],
                         ids=["dual", "dual-ovl1", "nodal-ovl1"])
def test_decomposition_identical(dual, overlap):
    ref_mesh, mesh = _meshes()
    ref = jax_partition_and_decompose(ref_mesh, 4, metis_dual=dual,
                                      add_overlap=overlap)
    got = partition_and_decompose(mesh, 4, metis_dual=dual,
                                  add_overlap=overlap)
    assert got.n_dom == ref.n_dom
    np.testing.assert_array_equal(got.node_mult, ref.node_mult)
    np.testing.assert_array_equal(got.elem_mult, ref.elem_mult)
    np.testing.assert_array_equal(got.node_part, ref.node_part)
    np.testing.assert_array_equal(got.adjacency(), ref.adjacency())
    for p in range(ref.n_dom):
        np.testing.assert_array_equal(got.elem_doms[p], ref.elem_doms[p])
        np.testing.assert_array_equal(got.dom_nodes[p], ref.dom_nodes[p])
        for q in range(ref.n_dom):
            np.testing.assert_array_equal(got.intersections[p][q],
                                          ref.intersections[p][q])


@pytest.fixture(scope="module")
def assembled_pair():
    ref_mesh, mesh = _meshes()
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    return ref, got


def test_batch_arrays_identical(assembled_pair):
    ref, got = assembled_pair
    rb, gb = ref.batch, got.batch
    assert (gb.n_dof, gb.n_dom, gb.n_max) == (rb.n_dof, rb.n_dom, rb.n_max)
    for name in ("gids", "mask", "mult", "a_neu", "a_dir"):
        np.testing.assert_array_equal(getattr(gb, name).numpy(),
                                      np.asarray(getattr(rb, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.nnz_loc, ref.nnz_loc)
    assert (got.a_csr != ref.a_csr).nnz == 0


def test_scatter_table_follows_sorted_scatter(assembled_pair):
    """Row g of the table lists the flat slots of DOF g in the order of
    the JAX package's sorted segment-sum (scatter_perm/sorted_gids)."""
    ref, got = assembled_pair
    perm = np.asarray(ref.batch.scatter_perm)
    sorted_gids = np.asarray(ref.batch.sorted_gids)
    table = scatter_table(np.asarray(ref.batch.gids), ref.batch.n_dof)
    np.testing.assert_array_equal(got.batch.scatter_idx.numpy(), table)
    pad = np.asarray(ref.batch.gids).size
    for g in range(ref.batch.n_dof):
        row = table[g][table[g] != pad]
        np.testing.assert_array_equal(row, perm[sorted_gids == g])


def test_matvec_matches_assembled_operator(assembled_pair):
    _, got = assembled_pair
    x = np.random.default_rng(3).standard_normal(got.n_dof)
    y = got.batch.matvec(torch.from_numpy(x)).numpy()
    want = got.a_csr @ x
    assert np.linalg.norm(y - want) <= 1e-14 * np.linalg.norm(want)


def test_scatter_add_is_bitwise_reproducible(assembled_pair):
    _, got = assembled_pair
    xl = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (got.batch.n_dom, got.batch.n_max)))
    a = got.batch.scatter_add(xl)
    b = got.batch.scatter_add(xl.clone())
    assert torch.equal(a, b)
    # pad slots never reach the global vector
    np.testing.assert_allclose(
        a.numpy(), np.bincount(got.batch.gids.numpy().ravel(),
                               weights=(xl * got.batch.mask).numpy().ravel(),
                               minlength=got.n_dof + 1)[:-1],
        rtol=1e-14, atol=1e-14)
