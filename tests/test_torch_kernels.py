"""K1 (fused_local_solve) and K2 (block_matvec) of the PyTorch port against
the JAX package's Pallas kernels (interpreter mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels themselves are compared with those plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).  Tolerance: atol 1e-12
in float64 — both sides sum the same products in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneo4petsc_tpu.ops.pallas_kernels import block_matvec as jax_block_matvec
from geneo4petsc_tpu.ops.pallas_kernels import (
    fused_local_solve as jax_fused_local_solve)
from geneo4petsc_tpu_torch.ops import local_kernels as lk

PAIRS = [(False, False), (True, False), (True, True)]


def _data(d, n, seed=0):
    rng = np.random.default_rng(seed)
    inv = rng.standard_normal((d, n, n))
    inv = 0.5 * (inv + inv.transpose(0, 2, 1))
    pou = rng.random((d, n)) + 0.5
    mask = rng.random((d, n)) > 0.2
    x = rng.standard_normal((d, n))
    return inv, pou, mask, x


@pytest.fixture(params=[(6, 16), (3, 37)], ids=["6x16", "ragged3x37"])
def data(request):
    return _data(*request.param)


@pytest.mark.parametrize("pre,post", PAIRS)
def test_fused_local_solve_matches_pallas(data, pre, post):
    inv, pou, mask, x = data
    want = np.asarray(jax_fused_local_solve(
        jnp.asarray(inv), jnp.asarray(pou), jnp.asarray(mask),
        jnp.asarray(x), pre=pre, post=post, interpret=True))
    before = lk.fused_local_solve.launches
    got = lk.fused_local_solve(torch.from_numpy(inv), torch.from_numpy(pou),
                               torch.from_numpy(mask), torch.from_numpy(x),
                               pre=pre, post=post)
    assert got.dtype == torch.float64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the CPU path runs the plain version and launches nothing
    assert lk.fused_local_solve.launches == before


def test_block_matvec_matches_pallas(data):
    inv, _, _, x = data
    a = inv + 3.0 * np.eye(inv.shape[-1])
    want = np.asarray(jax_block_matvec(jnp.asarray(a), jnp.asarray(x),
                                       interpret=True))
    before = lk.block_matvec.launches
    got = lk.block_matvec(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert lk.block_matvec.launches == before


def test_wrappers_reject_bad_inputs():
    inv, pou, mask, x = (torch.from_numpy(a) for a in _data(3, 5))
    with pytest.raises(ValueError, match="must be"):
        lk.block_matvec(inv, x[:, :4].contiguous())
    with pytest.raises(TypeError):
        lk.block_matvec(inv, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        lk.block_matvec(inv.transpose(1, 2), x)
    with pytest.raises(ValueError, match="contiguous"):
        lk.fused_local_solve(inv, pou, mask, x.t().contiguous().t())
    with pytest.raises(TypeError):
        lk.fused_local_solve(inv, pou, mask.double(), x)
    with pytest.raises(ValueError, match="weights"):
        lk.fused_local_solve(inv, None, mask, x, pre=True)
    with pytest.raises(ValueError, match="device"):
        lk.block_matvec(inv.to("meta"), x.to("meta"))


def test_unweighted_local_solve_needs_no_weights():
    inv, _, mask, x = (torch.from_numpy(a) for a in _data(3, 5))
    got = lk.fused_local_solve(inv, None, mask, x)
    want = torch.where(mask, torch.einsum("dij,dj->di", inv, x), 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)
