"""End-to-end structured solve driver — the large-scale (10M+ DOF) path.

The structured twin of solver.solve_mesh: grid -> box decomposition ->
FDM/stencil GenEO setup -> mixed-precision refined CG to the true-f64
tolerance (float32 Krylov iterations inside float64 outer refinement,
krylov/refine.py).  Host memory is O(N) fields (no element lists, no
CSR); device memory is O(N) vectors + O(n_dom L^2) FDM factors + the
coarse space.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import GenEOOptions, KSPOptions
from ..krylov.cg import cg_solve
from ..krylov.gmres import gmres_solve
from ..krylov.refine import (RefinedResult, refined_solve,
                             refined_solve_device)
from ..ops.batched_linalg import require_full_f32
from ..precond.geneo import GenEOStats
from ..utils.checkpoint import setup_with_checkpoint
from ..utils.timers import Timers
from .decompose import StructuredDecomposition
from .geneo import StructuredGenEO, setup_structured
from .grid import StructuredGrid, global_stencil


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


def make_structured_inner(pc: StructuredGenEO, inner_max_it: int = 2000,
                          ksp_type: str = "cg"):
    """Inner Krylov correction solver ``inner(r32, rtol)``, run in the
    preconditioner's dtype.  Inner solves stop on stagnation (the f32
    residual floor is problem-scaled; the f64 outer loop owns true
    convergence); inexact level-1 solves (PCG local solver) make the
    preconditioner vary slightly -> flexible CG."""
    extra = {"stall_its": 50, "flexible": not pc.l1_exact} \
        if ksp_type == "cg" else {}
    solver = cg_solve if ksp_type == "cg" else gmres_solve

    def inner(r32, rtol):
        r = r32.to(pc.x0.dtype)
        x0 = pc.apply_q(r) if pc.eff_hybrid else None
        return solver(pc.matvec, r, pc.apply, x0=x0, rtol=rtol,
                      max_it=inner_max_it, **extra)

    return inner


def solve_structured(grid: StructuredGrid, dom_grid, overlap: int,
                     geneo: GenEOOptions | None = None,
                     ksp: KSPOptions | None = None,
                     tol: float = 1e-8, dtype=torch.float32,
                     timers: Timers | None = None,
                     device="cuda", device_refine: bool | None = None,
                     lobpcg_start=None,
                     checkpoint_dir: str | None = None
                     ) -> StructuredSolveOutput:
    """Solve the grid's manufactured system (x = 1..n) on ``device``.

    device_refine (default: on for a CUDA device, off for the CPU, as
    the JAX package's accelerator rule): keep x/b/r on the device in
    float64 with the device stencil as the truth operator, instead of
    the host route (x on the host, NumPy stencil residuals).
    ``lobpcg_start``: see setup_structured.  ``checkpoint_dir``: cache
    the finished setup there and load it on a warm hit
    (utils.checkpoint.setup_with_checkpoint)."""
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
            timers=timers, device=device, lobpcg_start=lobpcg_start),
        grid, dom_grid, overlap, geneo, dtype, timers, checkpoint_dir,
        device)
    sync()
    timers.add("setup", time.perf_counter() - t0)

    t0 = time.perf_counter()
    # cap the inner correction solves: a stalled-at-the-f32-floor inner
    # must not burn 10k iterations — outer f64 passes pick up the slack
    ksp_type = ksp.type if ksp.type in ("cg", "gmres") else "cg"
    inner = make_structured_inner(pc, int(min(ksp.max_it, 2000)), ksp_type)
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
