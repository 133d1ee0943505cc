"""Tests of the PyTorch port that need a CUDA card; each skips without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)  Tolerances:
the kernels against their plain versions, max relative error 1e-12 in
float64 and 1e-5 in float32 (the sums run in another order); the cpu
and cuda solves, equal iteration counts and solutions within 1e-10."""

import numpy as np
import pytest
import torch

from geneo4petsc_tpu_torch.config import DriverOptions, GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.ops import local_kernels as lk
from geneo4petsc_tpu_torch.solver import solve_mesh

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(d, n, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    inv = torch.from_numpy(rng.standard_normal((d, n, n)))
    pou = torch.from_numpy(rng.random((d, n)) + 0.5)
    mask = torch.from_numpy(rng.random((d, n)) > 0.2)
    x = torch.from_numpy(rng.standard_normal((d, n)))
    return (inv.to(device, dtype), pou.to(device, dtype), mask.to(device),
            x.to(device, dtype))


def _rel(got, want):
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(7, 53), (1, 1), (33, 300)],
                         ids=["7x53", "1x1", "33x300"])
def test_kernels_match_plain(cuda, dtype, shape):
    inv, pou, mask, x = _data(*shape, cuda, dtype)
    for pre, post in [(False, False), (True, False), (False, True),
                      (True, True)]:
        before = lk.fused_local_solve.launches
        got = lk.fused_local_solve(inv, pou, mask, x, pre, post)
        assert lk.fused_local_solve.launches == before + 1
        want = lk.fused_local_solve_plain(inv, pou, mask, x, pre, post)
        assert _rel(got, want) <= TOL[dtype]
    before = lk.block_matvec.launches
    got = lk.block_matvec(inv, x)
    assert lk.block_matvec.launches == before + 1
    assert _rel(got, lk.block_matvec_plain(inv, x)) <= TOL[dtype]


def test_kernel_refuses_mixed_devices(cuda):
    inv, pou, mask, x = _data(3, 8, cuda, torch.float64)
    with pytest.raises(ValueError, match="on cpu"):
        lk.fused_local_solve(inv, pou, mask.cpu(), x)


def test_scatter_add_is_bitwise_reproducible_on_cuda(cuda):
    from geneo4petsc_tpu_torch.assembly.assemble import assemble
    from geneo4petsc_tpu_torch.partition.decompose import (
        partition_and_decompose)

    mesh = laplacian.get_input("--size 16 --dim 2")
    batch = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=2),
                     cuda).batch
    xl = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch.n_dom, batch.n_max))).to(cuda)
    assert torch.equal(batch.scatter_add(xl), batch.scatter_add(xl.clone()))


def test_solve_on_cuda_matches_cpu(cuda):
    mesh = laplacian.get_input("--size 16 --dim 2 --kappa 100. minmax")
    g = GenEOOptions()
    g.lvl1, g.lvl2 = "ASM", "E1"
    g.dls1.type = "inverse_pallas"
    kw = dict(n_dom=4, geneo=g, ksp=KSPOptions(type="cg", rtol=1e-8),
              driver=DriverOptions(add_overlap=1))
    ref = solve_mesh(mesh, torch.device("cpu"), **kw)
    k1, k2 = lk.fused_local_solve.launches, lk.block_matvec.launches
    got = solve_mesh(mesh, cuda, **kw)
    assert got.result.x.device.type == "cuda"
    assert (got.its, got.result.reason) == (ref.its, ref.result.reason)
    assert np.linalg.norm(got.x - ref.x) <= 1e-10 * np.linalg.norm(ref.x)
    assert lk.fused_local_solve.launches - k1 >= got.its
    assert lk.block_matvec.launches - k2 >= 2 * got.its
