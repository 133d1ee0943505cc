"""K1 (fused_local_solve) and K2 (block_matvec) of the PyTorch port against
the JAX package's Pallas kernels (interpreter mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels themselves are compared with those plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).  Tolerance: atol 1e-12
in float64 — both sides sum the same products in different orders.

The launch plan of the CUDA kernels (path, tile rows, ring depth, grid,
shared memory) is plain Python and is tested here without a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


# ---- the launch plan of the CUDA kernels (geometry only; runs anywhere) ----

SMS, SMEM = 132, 232448   # the limits of an H100, as the wrappers read them


def _assert_plan_sound(n_dom, n, itemsize, aligned, sm_count, smem_limit,
                       extra=0):
    plan = lk._stream_plan(n_dom, n, itemsize, aligned, sm_count, smem_limit,
                           extra)
    row_bytes = n * itemsize
    items = n_dom * -(-n // plan.rows)
    # every (domain, row) exactly once, in tiles that stay in one domain
    seen = np.zeros((n_dom, n), dtype=np.int64)
    blocks = set()
    for b, d, r0, rows in lk.stream_tiles(plan, n_dom, n):
        assert 0 <= b < plan.grid and rows >= 1
        seen[d, r0:r0 + rows] += 1
        blocks.add(b)
        if plan.path == "ring":
            assert (itemsize * n * (d * n + r0)) % 16 == 0
            assert (rows * row_bytes) % 16 == 0
            assert rows <= plan.rows
    assert (seen == 1).all()
    # the grid never exceeds the work, and no block is idle
    assert 1 <= plan.grid <= items and blocks == set(range(plan.grid))
    assert plan.threads % 32 == 0 and plan.threads >= 64
    if plan.path == "ring":
        assert aligned and row_bytes % 16 == 0
        assert 2 <= plan.stages <= lk.MAX_STAGES
        assert plan.grid <= sm_count * lk.BLOCKS_PER_SM
        assert plan.smem == lk._ring_smem(n, itemsize, extra, plan.rows,
                                          plan.stages) <= smem_limit
    else:
        assert plan.path == "direct" and plan.stages == 0
        assert plan.grid == items and plan.smem == row_bytes
        assert plan.rows == plan.threads // 32 * lk.ROWS_PER_WARP
        # only what the ring cannot take goes the direct path
        assert (not aligned or row_bytes % 16 != 0
                or lk._ring_smem(n, itemsize, extra, 1, 2) > smem_limit)
    return plan


@pytest.mark.parametrize("n_dom,n,itemsize,aligned,path", [
    (1024, 496, 8, True, "ring"),      # the slice's shape
    (3, 37, 8, True, "direct"),        # odd n
    (3, 37, 4, True, "direct"),
    (7, 50, 8, True, "ring"),          # fewer domains than SMs
    (5, 66, 4, True, "direct"),        # float32, n % 4 == 2
    (5, 64, 4, True, "ring"),          # float32, n % 4 == 0
    (133, 496, 8, True, "ring"),       # n_dom no multiple of the grid
    (2, 3000, 8, True, "ring"),        # large n
    (2, 9680, 8, True, "ring"),        # the largest n with two stages
    (2, 9682, 8, True, "direct"),      # x[d] + two rows exceed shared memory
    (7, 50, 8, False, "direct"),       # misaligned base pointer
    (1024, 496, 8, False, "direct"),
    (1, 1, 8, True, "direct"),
    (1, 2, 8, True, "ring"),
], ids=lambda v: str(v))
def test_stream_plan_cases(n_dom, n, itemsize, aligned, path):
    plan = _assert_plan_sound(n_dom, n, itemsize, aligned, SMS, SMEM)
    assert plan.path == path


def test_stream_plan_of_the_slice():
    plan = lk._stream_plan(1024, 496, 8, True, SMS, SMEM)
    # one persistent block per SM, 16 rows (63,488 B) a stage, 3 stages
    assert plan == lk.StreamPlan("ring", 16, 3, 132, 160, 194560)
    # K1 stages the mask (and the post-weights) beside x[d]
    for post in (False, True):
        extra = lk._local_solve_extra(496, 8, post)
        k1 = _assert_plan_sound(1024, 496, 8, True, SMS, SMEM, extra)
        assert (k1.path, k1.rows, k1.stages) == ("ring", 16, 3)
        assert k1.smem == plan.smem + -(-extra // 128) * 128


def test_stream_plan_follows_the_card():
    # half the SMs: half the grid; a small shared memory: fewer stages,
    # then the direct path
    assert lk._stream_plan(1024, 496, 8, True, 66, SMEM).grid == 66
    small = _assert_plan_sound(1024, 496, 8, True, SMS, 100 * 1024)
    assert small.path == "ring" and small.smem <= 100 * 1024
    assert _assert_plan_sound(1024, 496, 8, True, SMS, 8 * 1024).path == "direct"


@settings(max_examples=150, deadline=None, derandomize=True)
@given(n_dom=st.integers(1, 40), n=st.integers(1, 200),
       itemsize=st.sampled_from([4, 8]), aligned=st.booleans(),
       sm_count=st.integers(1, 160),
       smem_limit=st.sampled_from([48 * 1024, 99 * 1024, 163 * 1024, SMEM]),
       post=st.booleans())
def test_stream_plan_is_sound(n_dom, n, itemsize, aligned, sm_count,
                              smem_limit, post):
    _assert_plan_sound(n_dom, n, itemsize, aligned, sm_count, smem_limit)
    _assert_plan_sound(n_dom, n, itemsize, aligned, sm_count, smem_limit,
                       lk._local_solve_extra(n, itemsize, post))


def test_empty_batch_launches_nothing():
    inv = torch.zeros(0, 5, 5, dtype=torch.float64)
    x = torch.zeros(0, 5, dtype=torch.float64)
    assert lk.block_matvec(inv, x).shape == (0, 5)
    assert lk.fused_local_solve(inv, None, x.bool(), x).shape == (0, 5)
