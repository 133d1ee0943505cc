"""End-to-end structured solve driver — the large-scale (10M+ DOF) path.

The structured twin of solver.solve_mesh: grid -> box decomposition ->
FDM/stencil GenEO setup -> mixed-precision refined CG to the true-f64
tolerance (float32 Krylov iterations inside float64 outer refinement,
krylov/refine.py).  Host memory is O(N) fields (no element lists, no
CSR); device memory is O(N) vectors + O(n_dom L^2) FDM factors + the
coarse space.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import GenEOOptions, KSPOptions
from ..krylov import common as cm
from ..krylov.cg import cg_solve
from ..krylov.gmres import gmres_solve
from ..krylov.refine import (RefinedResult, refined_solve,
                             refined_solve_device)
from ..ops.batched_linalg import require_full_f32
from ..precond.geneo import GenEOStats
from ..utils.checkpoint import setup_with_checkpoint
from ..utils.timers import Timers
from ..parallel import multiproc
from .blockmode import BlockGenEO, build_block_mode
from .decompose import StructuredDecomposition
from .geneo import StructuredGenEO, setup_structured
from .grid import StructuredGrid, global_stencil, laplacian_grid


@dataclass
class StructuredSolveOutput:
    refined: RefinedResult
    x: np.ndarray
    b: np.ndarray
    pc_name: str
    stats: GenEOStats
    timers: Timers
    true_res: float
    n_dof: int
    n_dom: int
    pc: StructuredGenEO

    @property
    def converged(self) -> bool:
        return self.refined.converged

    @property
    def its(self) -> int:
        return self.refined.inner_its


def make_structured_inner(pc, inner_max_it: int = 2000,
                          ksp_type: str = "cg", ip: cm.Inner = cm.LOCAL):
    """Inner Krylov correction solver ``inner(r32, rtol)``, run in the
    preconditioner's dtype.  Inner solves stop on stagnation (the f32
    residual floor is problem-scaled; the f64 outer loop owns true
    convergence); inexact level-1 solves (PCG local solver) make the
    preconditioner vary slightly -> flexible CG.

    ``pc``: StructuredGenEO (global layout), BlockGenEO (the residual is
    permuted into brick order once, the whole Krylov loop runs on
    block-major vectors, the correction is permuted back) or
    ShardedGenEO (the rank's planes; ``ip`` then adds the ranks'
    partial inner products)."""
    extra = {"stall_its": 50, "flexible": not pc.l1_exact} \
        if ksp_type == "cg" else {}
    solver = cg_solve if ksp_type == "cg" else gmres_solve
    block = isinstance(pc, BlockGenEO)
    dtype = (pc.pc if block else pc).x0.dtype

    def inner(r32, rtol):
        r = r32.to(dtype)
        if block:
            r = pc.to_block(r)
        x0 = pc.apply_q(r) if pc.eff_hybrid else None
        res = solver(pc.matvec, r, pc.apply, x0=x0, rtol=rtol,
                     max_it=inner_max_it, ip=ip, **extra)
        if block:
            res = dataclasses.replace(res, x=pc.from_block(res.x))
        return res

    return inner


def solve_structured(grid: StructuredGrid, dom_grid, overlap: int,
                     geneo: GenEOOptions | None = None,
                     ksp: KSPOptions | None = None,
                     tol: float = 1e-8, dtype=torch.float32,
                     timers: Timers | None = None,
                     device="cuda", device_refine: bool | None = None,
                     lobpcg_start=None,
                     checkpoint_dir: str | None = None,
                     n_devices: int | None = None,
                     block_layout: bool = False,
                     bt_budget_bytes: float | None = None
                     ) -> StructuredSolveOutput:
    """Solve the grid's manufactured system (x = 1..n) on ``device``.

    device_refine (default: on for a CUDA device, off for the CPU, as
    the JAX package's accelerator rule): keep x/b/r on the device in
    float64 with the device stencil as the truth operator, instead of
    the host route (x on the host, NumPy stencil residuals).
    ``lobpcg_start``: the LOBPCG start block callback of setup_structured;
    without one, JAX's PRNGKey(0) draw is written masked on ``device``
    (``ops.start_draw``).  ``checkpoint_dir``: cache
    the finished setup there and load it on a warm hit
    (utils.checkpoint.setup_with_checkpoint).

    ``n_devices``: run on that many ranks (the reference's ``mpirun -n``,
    src/geneo4PETSc.cpp:1569-1633): z-slab vectors, contiguous domain
    chunks, E replicated (structured/sharded.py), the device refinement
    on the rank-split float64 operator.  In a torch.distributed group of
    that size this process is one rank; with no group, the ranks are
    launched here (parallel.multiproc.run_ranks) and rank 0's result
    comes back (without ``pc``).  Needs nz % n_devices == 0 and
    n_dom % n_devices == 0.

    ``block_layout`` (single process only, as in the JAX package): run
    the inner Krylov loop on block-major vectors (structured/blockmode.py)
    so that the per-iteration apply pays no global <-> brick permute.

    ``bt_budget_bytes``: the factor memory allowed to the exact
    block-tridiagonal route of the general local solvers (setup_structured;
    default solvers.BT_BUDGET_BYTES, 2 GB); 0 forces the inexact
    surrogate-PCG route."""
    if n_devices is not None:
        from .sharded import need_divisible
        need_divisible(grid.shape[2], int(np.prod(dom_grid)), n_devices)
        ranks = multiproc.group_ranks(n_devices, device)
        if ranks is None:
            return multiproc.run_ranks(_rank_solve, n_devices, args=(
                grid, dom_grid, overlap, dict(
                    geneo=geneo, ksp=ksp, tol=tol, dtype=dtype,
                    device=str(torch.device(device).type),
                    device_refine=device_refine, lobpcg_start=lobpcg_start,
                    checkpoint_dir=checkpoint_dir, n_devices=n_devices,
                    bt_budget_bytes=bt_budget_bytes)),
                device=device)
        return _solve_ranks(grid, dom_grid, overlap, ranks,
                            geneo or GenEOOptions(), ksp or KSPOptions(),
                            tol, dtype, timers or Timers(), lobpcg_start,
                            device_refine, checkpoint_dir, bt_budget_bytes)
    geneo = geneo or GenEOOptions()
    ksp = ksp or KSPOptions()
    timers = timers or Timers()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(pass device='cpu' to run on the host)")
    require_full_f32()
    if device_refine is None:
        device_refine = device.type == "cuda"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    sd = StructuredDecomposition(grid, tuple(dom_grid), overlap)
    timers.add("partition", time.perf_counter() - t0)

    t0 = time.perf_counter()
    if device_refine:
        gop64 = global_stencil(grid, torch.float64, device)
        x_true = torch.arange(1, grid.n_nodes + 1, dtype=torch.float64,
                              device=device)
        b = gop64.matvec(x_true)
        del x_true
        sync()
    else:
        _x_true, b = grid.manufactured_rhs()
    timers.add("createA", time.perf_counter() - t0)

    t0 = time.perf_counter()
    pc, stats = setup_with_checkpoint(
        lambda: setup_structured(
            sd, geneo, b=torch.as_tensor(b).to(device, dtype), dtype=dtype,
            timers=timers, device=device, lobpcg_start=lobpcg_start,
            bt_budget_bytes=bt_budget_bytes),
        grid, dom_grid, overlap, geneo, dtype, timers, checkpoint_dir,
        device, bt_budget_bytes=bt_budget_bytes)
    pc_iter = build_block_mode(pc, sd, dtype, device) if block_layout \
        else pc
    sync()
    timers.add("setup", time.perf_counter() - t0)

    t0 = time.perf_counter()
    # cap the inner correction solves: a stalled-at-the-f32-floor inner
    # must not burn 10k iterations — outer f64 passes pick up the slack
    ksp_type = ksp.type if ksp.type in ("cg", "gmres") else "cg"
    inner = make_structured_inner(pc_iter, int(min(ksp.max_it, 2000)),
                                  ksp_type)
    x0 = pc.x0.double() if geneo.eff_hybrid else None
    if device_refine:
        ref = refined_solve_device(gop64, b, inner, tol=tol, x0=x0)
        true_res = ref.true_res
    else:
        ref = refined_solve(
            b, lambda x: b - grid.matvec(x), inner, tol=tol,
            x0=None if x0 is None else x0.cpu().numpy(), device=device)
        true_res = float(np.linalg.norm(b - grid.matvec(ref.x))
                         / np.linalg.norm(b))
    sync()
    timers.add("solve", time.perf_counter() - t0)
    if device_refine:
        ref.x, b = ref.x.cpu().numpy(), b.cpu().numpy()
    return StructuredSolveOutput(
        refined=ref, x=ref.x, b=b, pc_name=geneo.name, stats=stats,
        timers=timers, true_res=true_res, n_dof=grid.n_nodes,
        n_dom=sd.n_dom, pc=pc)


def host_output(out: StructuredSolveOutput) -> StructuredSolveOutput:
    """A solve's output with nothing on a device (what a launched rank
    hands back)."""
    return dataclasses.replace(out, pc=None)


def _rank_solve(grid, dom_grid, overlap, kw):
    """One launched rank of solve_structured(n_devices=...)."""
    return host_output(solve_structured(grid, dom_grid, overlap, **kw))


def _solve_ranks(grid, dom_grid, overlap, ranks, geneo, ksp, tol, dtype,
                 timers, lobpcg_start, device_refine, checkpoint_dir,
                 bt_budget_bytes) -> StructuredSolveOutput:
    """This rank's part of a multi-rank solve: the setup replicated on
    every rank, then the iterations on the rank's planes and domains, by
    the single-process refinement route (``device_refine``, default: the
    device route on a card, the host route on the CPU)."""
    from .sharded import shard_refine64, shard_structured

    device = ranks.device
    require_full_f32()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    sd = StructuredDecomposition(grid, tuple(dom_grid), overlap)
    timers.add("partition", time.perf_counter() - t0)

    if device_refine is None:
        device_refine = device.type == "cuda"
    t0 = time.perf_counter()
    if device_refine:
        gop64 = global_stencil(grid, torch.float64, device)
        b = gop64.matvec(torch.arange(1, grid.n_nodes + 1,
                                      dtype=torch.float64, device=device))
    else:
        _x_true, b = grid.manufactured_rhs()
    sync()
    timers.add("createA", time.perf_counter() - t0)

    t0 = time.perf_counter()
    pc, stats = setup_with_checkpoint(
        lambda: setup_structured(
            sd, geneo, b=torch.as_tensor(b).to(device, dtype), dtype=dtype,
            timers=timers, device=device, lobpcg_start=lobpcg_start,
            bt_budget_bytes=bt_budget_bytes),
        grid, dom_grid, overlap, geneo, dtype, timers, checkpoint_dir,
        device, ranks, bt_budget_bytes=bt_budget_bytes)
    _mv, _ap, sh, shard_vec = shard_structured(pc, ranks)
    if device_refine:
        op64 = shard_refine64(gop64, ranks)
        b_own = shard_vec(b)
        del gop64, b
    sync()
    timers.add("setup", time.perf_counter() - t0)

    t0 = time.perf_counter()
    ip = cm.DistInner(ranks.group)
    ksp_type = ksp.type if ksp.type in ("cg", "gmres") else "cg"
    inner = make_structured_inner(sh, int(min(ksp.max_it, 2000)), ksp_type,
                                  ip=ip)
    x0 = sh.x0.double() if geneo.eff_hybrid else None
    if device_refine:
        ref = refined_solve_device(op64, b_own, inner, tol=tol, x0=x0, ip=ip)
        ref.x, b = sh.unshard(ref.x), sh.unshard(b_own)
        true_res = ref.true_res
    else:
        # the host route: x, b and the float64 residual on the host (every
        # rank holds them), the inner solves on the ranks
        def inner_host(r32, rtol):
            res = inner(shard_vec(r32), rtol)
            return dataclasses.replace(res, x=torch.from_numpy(
                sh.unshard(res.x)))

        ref = refined_solve(
            b, lambda x: b - grid.matvec(x), inner_host, tol=tol,
            x0=None if x0 is None else sh.unshard(x0), device=device)
        true_res = float(np.linalg.norm(b - grid.matvec(ref.x))
                         / np.linalg.norm(b))
    sync()
    timers.add("solve", time.perf_counter() - t0)
    return StructuredSolveOutput(
        refined=ref, x=ref.x, b=b, pc_name=geneo.name,
        stats=stats, timers=timers, true_res=true_res,
        n_dof=grid.n_nodes, n_dom=sd.n_dom, pc=sh)


def laplacian_structured(size: int, dim: int = 3, kappa_max: float = 1.0,
                         interp: str = "", inp_eps: float = 0.0001,
                         weak_scaling: int = 1) -> StructuredGrid:
    """The vectorized laplacian grid (laplacian_grid) under the JAX
    package's public name."""
    return laplacian_grid(size, dim=dim, kappa_max=kappa_max,
                          interp=interp, inp_eps=inp_eps,
                          weak_scaling=weak_scaling)
