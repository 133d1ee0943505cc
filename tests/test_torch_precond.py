"""GenEO preconditioner of the PyTorch port against the JAX package:
equal setup statistics and the same apply, on laplacian --size 10
--dim 2 with 4 domains and overlap 1.

Tolerance of the applies: 1e-12 relative (norm-wise) in float64 — the
two packages factor the local blocks with different LAPACK routes
(batched Cholesky-inverse vs np.linalg.inv; cholesky_solve vs two
triangular solves) and sum in different orders."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.partition.decompose import (
    partition_and_decompose as jax_partition_and_decompose)
from geneo4petsc_tpu.precond.geneo import setup_geneo as jax_setup_geneo
from geneo4petsc_tpu_torch.assembly.assemble import assemble
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.partition.decompose import partition_and_decompose
from geneo4petsc_tpu_torch.precond.geneo import setup_geneo
from geneo4petsc_tpu_torch.utils.convert import pc_from_arrays

CPU = torch.device("cpu")
GEN_ARGS = "--size 10 --dim 2"
LVL1 = ["ASM", "RAS", "SRAS", "SORAS"]
LVL2 = ["0", "1", "H1", "E1", "2"]
DLS1 = ["cholesky", "inverse_pallas"]


@pytest.fixture(scope="module")
def problems():
    """(JAX assembled, port assembled, rhs, probe vector)."""
    ref_mesh = jax_laplacian.get_input(GEN_ARGS)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    mesh = laplacian.get_input(GEN_ARGS)
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    rng = np.random.default_rng(7)
    return ref, got, rng.standard_normal(mesh.n_nodes), \
        rng.standard_normal(mesh.n_nodes)


def _opts(cls, lvl1, lvl2, dls1, optim=0.0):
    g = cls()
    g.lvl1, g.lvl2 = lvl1, lvl2
    g.dls1.type = dls1
    g.optim = optim
    return g


def _setup_both(problems, lvl1, lvl2, dls1):
    ref, got, b, _ = problems
    ref_pc, ref_st = jax_setup_geneo(
        ref.batch, _opts(JaxGenEOOptions, lvl1, lvl2, dls1),
        b=jnp.asarray(b), decomp=ref.decomp, a_csr=ref.a_csr)
    pc, st = setup_geneo(got.batch, _opts(GenEOOptions, lvl1, lvl2, dls1),
                         b=torch.from_numpy(b), decomp=got.decomp,
                         a_csr=got.a_csr)
    return ref_pc, ref_st, pc, st


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dls1", DLS1)
@pytest.mark.parametrize("lvl2", LVL2)
@pytest.mark.parametrize("lvl1", LVL1)
def test_setup_and_apply_match_jax(problems, lvl1, lvl2, dls1):
    ref_pc, ref_st, pc, st = _setup_both(problems, lvl1, lvl2, dls1)
    for name in ("real_dim_e", "nicolaides", "estim_dim_e", "tau_loc",
                 "gamma_loc"):
        np.testing.assert_array_equal(getattr(st, name),
                                      getattr(ref_st, name), err_msg=name)
    assert (pc.dim_e, st.e_null, st.e_pruned) == \
        (ref_pc.dim_e, ref_st.e_null, ref_st.e_pruned)
    x = problems[3]
    want = np.asarray(ref_pc.apply(jnp.asarray(x)))
    assert _rel(pc.apply(torch.from_numpy(x)).numpy(), want) <= 1e-12
    ref_x0 = np.asarray(ref_pc.x0)
    if lvl2 == "E1":
        assert _rel(pc.x0.numpy(), ref_x0) <= 1e-12
    else:
        assert not ref_x0.any() and not pc.x0.any()


def _arrays(ref_pc):
    """The JAX preconditioner's leaves as NumPy arrays (+ static fields)."""
    b = ref_pc.batch
    leaf = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    l1 = ref_pc.l1_factor
    d = {"gids": leaf(b.gids), "mask": leaf(b.mask), "mult": leaf(b.mult),
         "a_neu": leaf(b.a_neu), "a_dir": leaf(b.a_dir), "n_dof": b.n_dof,
         "l1_factor": tuple(map(leaf, l1)) if isinstance(l1, tuple)
         else leaf(l1),
         "pou": leaf(ref_pc.pou), "z_loc": leaf(ref_pc.z_loc),
         "colids": leaf(ref_pc.colids), "e_evecs": leaf(ref_pc.e_evecs),
         "e_eig_inv": leaf(ref_pc.e_eig_inv), "x0": leaf(ref_pc.x0)}
    meta = {k: getattr(ref_pc, k) for k in ("lvl1", "lvl2", "hybrid",
                                            "eff_hybrid", "dim_e", "k_max",
                                            "l1_kind")}
    return d, meta


# optim 0.3 makes the SORAS level-1 blocks true Robin blocks
@pytest.mark.parametrize("lvl1,lvl2,dls1,optim", [
    ("ASM", "E1", "inverse_pallas", 0.0), ("SRAS", "H1", "cholesky", 0.0),
    ("SORAS", "2", "cholesky", 0.0), ("SORAS", "H1", "inverse", 0.3),
    ("RAS", "1", "lu", 0.0), ("ASM", "0", "inverse", 0.0)])
def test_converted_jax_preconditioner_applies_alike(problems, lvl1, lvl2,
                                                    dls1, optim):
    ref, _, b, x = problems
    ref_pc, _ = jax_setup_geneo(
        ref.batch, _opts(JaxGenEOOptions, lvl1, lvl2, dls1, optim),
        b=jnp.asarray(b), decomp=ref.decomp, a_csr=ref.a_csr)
    if dls1 == "inverse_pallas":
        # both sides then run the fused level-1 kernel's math
        assert ref_pc.use_pallas
    d, meta = _arrays(ref_pc)
    pc = pc_from_arrays(d, meta, CPU)
    assert pc.l1_kind == ref_pc.l1_kind
    want = np.asarray(ref_pc.apply(jnp.asarray(x)))
    assert _rel(pc.apply(torch.from_numpy(x)).numpy(), want) <= 1e-12
    np.testing.assert_array_equal(pc.x0.numpy(), np.asarray(ref_pc.x0))


def test_convert_rejects_missing_fields(problems):
    ref_pc, *_ = _setup_both(problems, "ASM", "1", "cholesky")
    d, meta = _arrays(ref_pc)
    with pytest.raises(KeyError, match="k_max"):
        pc_from_arrays(d, {k: v for k, v in meta.items() if k != "k_max"},
                       CPU)
    with pytest.raises(KeyError, match="a_neu"):
        pc_from_arrays({k: v for k, v in d.items() if k != "a_neu"}, meta,
                       CPU)


def test_apply_is_deterministic(problems):
    _, _, pc, _ = _setup_both(problems, "SORAS", "H1", "inverse_pallas")
    x = torch.from_numpy(problems[3])
    assert torch.equal(pc.apply(x), pc.apply(x.clone()))
    # dropping the Dirichlet blocks after setup does not change the apply
    pc2 = dataclasses.replace(pc, batch=dataclasses.replace(pc.batch,
                                                            a_dir=None))
    assert torch.equal(pc2.apply(x), pc.apply(x))
