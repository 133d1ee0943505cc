"""The structured PCG local solver's loop and its fused iteration
(``ops/pcg_fused.py``) on the CPU, where the fused passes run their plain
versions: ``PCGSolver.solve`` against the loop of ``start`` and ``step``
it replaced, bit for bit (the same torch ops in the same order), with
one preconditioner solve an iteration; a LocalStencil's passes against
the plain passes, bit for bit; the passes' checks and launch geometry.
The kernels themselves run in tests/test_torch_cuda.py on a card."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.ops import pcg_fused
from geneo4petsc_tpu_torch.structured import elastic as el
from geneo4petsc_tpu_torch.structured import grid as tgrid
from geneo4petsc_tpu_torch.structured import local_ops as lo
from geneo4petsc_tpu_torch.structured import solvers
from geneo4petsc_tpu_torch.structured.decompose import \
    StructuredDecomposition
from geneo4petsc_tpu_torch.utils import roofline


class _Counting:
    """A preconditioner that counts its solves."""

    def __init__(self, pre):
        self.pre, self.calls = pre, 0

    def solve(self, x):
        self.calls += 1
        return self.pre.solve(x)


def _step_loop(pcg, x):
    """The loop PCGSolver.solve ran before: ``start``, then ``step`` while
    a system's r.r is above its tolerance (a preconditioner solve in
    ``start`` and one in every step).  Returns (u, iterations)."""
    m, tol2, state = pcg.start(x)
    it = 0
    while it < pcg.max_it and bool(
            (pcg._dots(state[1], state[1]) > tol2).any()):
        state = pcg.step(m, state)
        it += 1
    return state[0] * m, it


@pytest.fixture(scope="module")
def inclusion():
    """The level-1 Dirichlet PCG of a float64 inclusion grid, 8^3 on
    2 x 1 x 1 boxes, overlap 1."""
    sd = StructuredDecomposition(
        tgrid.inclusion_grid(8, dim=3, kappa_max=1e3, n_inc=4), (2, 1, 1),
        1)
    f = lo.gather_fields(sd, dtype=torch.float64, device="cpu")
    st = lo.dirichlet_stencil(f)
    maskf = f.mask.to(torch.float64)
    return solvers.PCGSolver(st=st, pre=solvers.surrogate_fdm(st, maskf),
                             maskf=maskf, rtol=1e-6, max_it=100)


def _rhs(pcg, cols, seed=0):
    shape = tuple(pcg.maskf.shape)
    if cols:
        shape = shape[:1] + (cols,) + shape[1:]
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape))


@pytest.mark.parametrize("cols", [0, 3], ids=["vector", "block"])
@pytest.mark.parametrize("max_it", [100, 5, 0])
def test_solve_is_the_step_loop_with_one_pre_solve_an_iteration(
        inclusion, cols, max_it):
    pcg = dataclasses.replace(inclusion, max_it=max_it)
    x = _rhs(pcg, cols)
    counting = _Counting(pcg.pre)
    s0, i0 = solvers.PCGSolver.solves, solvers.PCGSolver.iterations
    u = dataclasses.replace(pcg, pre=counting).solve(x)
    its = solvers.PCGSolver.iterations - i0
    assert solvers.PCGSolver.solves == s0 + 1
    want, want_its = _step_loop(pcg, x)
    assert its == want_its <= max_it and (its > 0) == (max_it > 0)
    assert counting.calls == its
    assert torch.equal(u, want)


def test_solve_of_a_converged_system_takes_no_iteration(inclusion):
    counting = _Counting(inclusion.pre)
    i0 = solvers.PCGSolver.iterations
    u = dataclasses.replace(inclusion, pre=counting).solve(
        torch.zeros(tuple(inclusion.maskf.shape), dtype=torch.float64))
    assert solvers.PCGSolver.iterations == i0 and counting.calls == 0
    assert not u.any()


def _plain_workspace(self, r):
    return pcg_fused.Workspace(self.st, self.maskf, r, axes=3)


def _solve_counted(pcg, x):
    """(u, iterations, preconditioner solves) of ``pcg.solve(x)``."""
    counting = _Counting(pcg.pre)
    i0 = solvers.PCGSolver.iterations
    u = dataclasses.replace(pcg, pre=counting).solve(x)
    return u, solvers.PCGSolver.iterations - i0, counting.calls


@pytest.mark.parametrize("cols", [0, 3], ids=["vector", "block"])
def test_fused_loop_equals_the_torch_loop(inclusion, cols, monkeypatch):
    """A LocalStencil's solve takes the wrappers of ops/pcg_fused.py (the
    kernels on a card), which compute their plain versions on the CPU:
    the same bits and counts as the plain passes that any other operator
    takes."""
    x = _rhs(inclusion, cols, seed=1)
    assert inclusion._workspace(x)._passes == (
        pcg_fused.pcg_matvec, pcg_fused.pcg_update, pcg_fused.pcg_dot)
    got, its, calls = _solve_counted(inclusion, x)
    monkeypatch.setattr(solvers.PCGSolver, "_workspace", _plain_workspace)
    want, want_its, _ = _solve_counted(inclusion, x)
    assert its == want_its > 0 and calls == its
    assert torch.equal(got, want)


@pytest.mark.parametrize("cols", [0, 3], ids=["vector", "block"])
def test_solve_of_a_strided_right_hand_side(inclusion, cols):
    """A right-hand side that is a strided view (as a reshaped slice of a
    LOBPCG block can be) is solved as its contiguous copy: the passes,
    which take only contiguous tensors, run, with the same bits."""
    x = _rhs(inclusion, cols, seed=3)
    strided = x.transpose(-1, -3).contiguous().transpose(-1, -3)
    assert not strided.is_contiguous() and torch.equal(strided, x)
    got, its, _ = _solve_counted(inclusion, strided)
    want, want_its, _ = _solve_counted(inclusion, x)
    assert its == want_its > 0 and torch.equal(got, want)


@pytest.mark.parametrize("dims", [(-4, -3, -2, -1), (-3, -2), (0, 1, 2)])
def test_systems_are_trailing_axes_and_a_stencils_are_its_boxes(
        inclusion, dims):
    """reduce_dims must be the trailing axes of a system, and those of a
    LocalStencil its box's three: anything else is refused."""
    with pytest.raises(ValueError, match="reduce_dims"):
        dataclasses.replace(inclusion, reduce_dims=dims)


def test_plain_workspace_takes_systems_of_any_axes():
    """A workspace of the plain passes over systems of four trailing axes
    (the elastic backend's): one partial a system, and its sums those of
    the systems."""
    st, mask, (z, p, u, r), _, _ = _pieces()
    ws = pcg_fused.Workspace(st, mask, r, axes=4)
    assert ws.pw.shape == ws.rz.shape == ws.rr.shape == (1, 1)
    ws.dot(r, z)
    assert torch.equal(ws.rz[:, 0], (r * z).sum((0, 1, 2, 3), keepdim=True)
                       .reshape(-1))
    ws.update(u, r, ws.matvec(z, p, first=True))
    assert torch.equal(ws.rr_sums(), (r * r).sum((0, 1, 2, 3),
                                                  keepdim=True).reshape(-1))


def test_elastic_pcg_keeps_its_counts():
    """The elastic backend's level-1 PCG (a Robin operator with the
    component axis in its systems) runs the torch loop: the step loop's
    u and count, one preconditioner solve an iteration."""
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "SORAS", "0"
    o.dls1.rtol, o.dls1.max_it = 1e-8, 200
    g = el.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    pc, _ = el.setup_elastic(g, (2, 2, 1), 1, o, dtype=torch.float64,
                             device="cpu")
    l1 = pc.l1
    assert isinstance(l1, solvers.PCGSolver)
    assert tuple(l1.reduce_dims) == (-4, -3, -2, -1)
    shape = (l1.maskf.shape[0], 3) + tuple(l1.maskf.shape[1:])
    x = torch.from_numpy(np.random.default_rng(2).normal(size=shape))
    counting = _Counting(l1.pre)
    i0 = solvers.PCGSolver.iterations
    u = dataclasses.replace(l1, pre=counting).solve(x)
    its = solvers.PCGSolver.iterations - i0
    want, want_its = _step_loop(l1, x)
    assert its == want_its > 0 and counting.calls == its
    assert torch.equal(u, want)


def test_plan_of_the_10m_boxes():
    """The launch geometry on a card at the 10M cells' level-1 shape:
    tiles of 8 whole rows, z-chunks of 8 planes, 64 p.w partials and 96
    elementwise partials a system; one partial on the CPU."""
    pl = pcg_fused.plan((64, 58, 58, 58), "cuda")
    assert (pl.n_sys, pl.m, pl.box) == (64, 1, (58, 58, 58))
    assert (pl.ty, pl.sx, pl.zc) == (8, 58, 8)
    assert pl.n_mv == 8 * 1 * 8 and pl.n_el == 96
    blk = pcg_fused.plan((3, 2, 7, 11, 13), "cuda")
    assert (blk.n_sys, blk.m, blk.ty, blk.sx, blk.zc) == (6, 2, 11, 13, 7)
    assert blk.n_mv == 1 and blk.n_el == 1
    wide = pcg_fused.plan((2, 1, 3, 1000), "cuda")
    assert (wide.ty, wide.sx, wide.n_mv) == (1, 512, 3 * 2)
    cpu = pcg_fused.plan((64, 58, 58, 58), "cpu")
    assert (cpu.n_mv, cpu.n_el) == (1, 1)


def _pieces(dtype=torch.float64):
    shape = (2, 3, 4, 5)
    gen = torch.Generator().manual_seed(0)
    st = lo.LocalStencil(
        diag=torch.rand(shape, generator=gen, dtype=dtype) + 6.0,
        offs=tuple(-torch.rand(shape, generator=gen, dtype=dtype)
                   for _ in range(3)))
    mask = torch.ones(shape, dtype=dtype)
    vecs = [torch.randn(shape, generator=gen, dtype=dtype)
            for _ in range(4)]
    parts = torch.ones((2, 1), dtype=dtype)
    return st, mask, vecs, parts, torch.ones(2, dtype=dtype)


def test_plain_passes_are_the_steps_ops():
    """pcg_matvec, pcg_update and pcg_dot on CPU tensors: the direction,
    product, update and dots of PCGSolver.step."""
    st, mask, (z, p, u, r), parts, rz_prev = _pieces()
    launches = (pcg_fused.pcg_matvec.launches, pcg_fused.pcg_update.launches,
                pcg_fused.pcg_dot.launches)
    rz = torch.tensor([[2.0], [3.0]], dtype=torch.float64)
    rz_prev = torch.tensor([4.0, -1.0], dtype=torch.float64)
    p_new, w, pw = torch.empty_like(p), torch.empty_like(p), parts.clone()
    pcg_fused.pcg_matvec(st, mask, z, p, p_new, w, rz, rz_prev, pw, False)
    beta = torch.tensor([0.5, 0.0], dtype=torch.float64).view(2, 1, 1, 1)
    assert torch.equal(p_new, z + beta * p)
    assert torch.equal(w, st.matvec(p_new) * mask)
    assert torch.equal(pw[:, 0], (p_new * w).sum((1, 2, 3)))
    first = torch.empty_like(p)
    pcg_fused.pcg_matvec(st, mask, z, p, first, w, rz, rz_prev, pw, True)
    assert torch.equal(first, p)
    u0, r0, rr = u.clone(), r.clone(), parts.clone()
    pcg_fused.pcg_update(u, r, p_new, w, pw, rz, rz_prev, rr)
    alpha = (rz[:, 0] / pw[:, 0]).view(2, 1, 1, 1)
    assert torch.equal(u, u0 + alpha * p_new)
    assert torch.equal(r, r0 - alpha * w)
    assert torch.equal(rz_prev, rz[:, 0])
    assert torch.equal(rr[:, 0], (r * r).sum((1, 2, 3)))
    pcg_fused.pcg_dot(r, z, rz)
    assert torch.equal(rz[:, 0], (r * z).sum((1, 2, 3)))
    assert launches == (pcg_fused.pcg_matvec.launches,
                        pcg_fused.pcg_update.launches,
                        pcg_fused.pcg_dot.launches)


@pytest.mark.parametrize("fault", ["dtype", "mixed", "strided", "shape",
                                   "field", "parts", "scalars", "rank"])
def test_passes_refuse_what_the_kernels_do_not_take(fault):
    st, mask, (z, p, u, r), parts, rz_prev = _pieces()
    args = dict(r=r, z=z, rz_parts=parts.clone())
    if fault == "dtype":
        args.update(r=r.to(torch.int64), z=z.to(torch.int64))
    elif fault == "mixed":
        args.update(z=z.float())
    elif fault == "strided":
        args.update(z=z.transpose(1, 3).contiguous().transpose(1, 3))
    elif fault == "shape":
        args.update(z=z[:, :2].contiguous())
    elif fault == "parts":
        args.update(rz_parts=torch.ones((3, 1), dtype=torch.float64))
    elif fault == "rank":
        args.update(r=r[0], z=z[0])
    if fault in ("field", "scalars"):
        bad_mask = mask[:, :2].contiguous() if fault == "field" else mask
        bad_prev = rz_prev if fault == "field" else rz_prev[:1]
        with pytest.raises(ValueError):
            pcg_fused.pcg_matvec(st, bad_mask, z, p, torch.empty_like(p),
                                 torch.empty_like(p), parts, bad_prev,
                                 parts.clone(), False)
        return
    with pytest.raises((TypeError, ValueError)):
        pcg_fused.pcg_dot(**args)


def test_workspace_alternates_two_directions():
    """Workspace.matvec writes the new direction into its spare buffer
    and keeps the old one as the next spare: two direction buffers."""
    st, mask, (z, p, u, r), parts, _ = _pieces()
    ws = pcg_fused.Workspace(st, mask, r)
    spare = ws.spare
    ws.dot(r, z)
    p1 = ws.matvec(z, z, first=True)
    assert p1 is spare and ws.spare is z
    ws.update(u, r, p1)
    z2 = z.clone()
    ws.dot(r, z2)
    p2 = ws.matvec(z2, p1, first=False)
    assert p2 is z and ws.spare is p1
    assert torch.equal(ws.rr_sums(), (r * r).sum((1, 2, 3)))


def test_pcg_step_model_counts_each_array_once():
    """pcg_step_model at the 10M cells' level-1 ([64, 58^3] float32, one
    column): 17 passes of 4 bytes a point, 0.849 GB, 26 operations a
    point; a block of m columns reads the fields once."""
    loc = 64 * 58 ** 3
    mod = roofline.pcg_step_model(loc, 1, 4)
    assert mod["pcg_matvec"] == (9 * loc * 4, 18 * loc)
    assert mod["pcg_update"] == (6 * loc * 4, 6 * loc)
    assert mod["pcg_dot"] == (2 * loc * 4, 2 * loc)
    total = sum(b for b, _ in mod.values())
    assert total == 849_127_424
    blk = roofline.pcg_step_model(loc, 3, 8)
    assert blk["pcg_matvec"][0] == (4 * 3 + 5) * loc * 8


def test_launches_are_host_ops_while_a_profiler_records():
    """A launch runs inside a host op named after its kernel while a
    profiler records (so that the profiler links the kernel to the op and
    the ranges around it), and inside nothing otherwise."""
    assert isinstance(pcg_fused._host_op("pcg_dot"),
                      contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pcg_fused._host_op("pcg_dot"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pcg_fused.pcg_dot") == 1
