"""The Krylov loops' inner-product hook (krylov/common.py).

The single-process path keeps its exact operations: CG, GMRES and the
device refinement give the same bits with the default ``Inner`` as with
it passed explicitly, and a ``DistInner`` over a one-rank group (an
all_reduce of one partial, the 2-norm as sqrt of the summed square of
the local norm) gives those same bits too — the one-rank NCCL run of
chip_smoke.py leans on it."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from geneo4petsc_tpu_torch.krylov import common as cm
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.krylov.gmres import gmres_solve
from geneo4petsc_tpu_torch.krylov.refine import refined_solve_device


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield cm.DistInner(dist.group.WORLD)
    dist.destroy_process_group()


def _system(n=60, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    a = torch.from_numpy(q @ q.T + n * np.eye(n))
    d = torch.from_numpy(1.0 / np.diag(a.numpy()).copy())
    b = torch.from_numpy(rng.standard_normal(n))
    return (lambda v: a @ v), (lambda v: d * v), b


def _same(r1, r2):
    assert (r1.its, r1.reason) == (r2.its, r2.reason)
    assert torch.equal(r1.x, r2.x)
    assert torch.equal(r1.history.nan_to_num(-1.0),
                       r2.history.nan_to_num(-1.0))


@pytest.mark.parametrize("flexible", [False, True])
@pytest.mark.parametrize("norm_type", ["preconditioned", "unpreconditioned",
                                       "natural"])
def test_cg_bits_unchanged_by_the_hook(one_rank, norm_type, flexible):
    mv, pc, b = _system()
    kw = dict(rtol=1e-10, norm_type=norm_type, flexible=flexible)
    ref = cg_solve(mv, b, pc, **kw)
    _same(ref, cg_solve(mv, b, pc, ip=cm.LOCAL, **kw))
    _same(ref, cg_solve(mv, b, pc, ip=one_rank, **kw))


def test_gmres_bits_unchanged_by_the_hook(one_rank):
    mv, pc, b = _system()
    ref = gmres_solve(mv, b, pc, rtol=1e-10, restart=7)
    _same(ref, gmres_solve(mv, b, pc, rtol=1e-10, restart=7, ip=cm.LOCAL))
    _same(ref, gmres_solve(mv, b, pc, rtol=1e-10, restart=7, ip=one_rank))


def test_device_refinement_bits_unchanged_by_the_hook(one_rank):
    mv, pc, b = _system()

    class Op:
        matvec = staticmethod(mv)

    def inner_with(ip):
        def inner(r32, rtol):
            return cg_solve(lambda v: mv(v.double()).float(), r32,
                            lambda v: pc(v.double()).float(), rtol=rtol,
                            stall_its=50, ip=ip)
        return inner

    ref = refined_solve_device(Op, b * 1e3, inner_with(cm.LOCAL), tol=1e-12)
    got = refined_solve_device(Op, b * 1e3, inner_with(one_rank), tol=1e-12,
                               ip=one_rank)
    assert (ref.outer_its, ref.inner_its) == (got.outer_its, got.inner_its)
    assert torch.equal(ref.x, got.x) and ref.history == got.history
