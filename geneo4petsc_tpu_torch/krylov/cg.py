"""Preconditioned conjugate gradients with PETSc KSPCG semantics.

Left-preconditioned PCG; norm_type selects the convergence quantity
(PETSc KSPSolve_CG):
  * "preconditioned"   -> ||z||_2 = ||M^-1 r||_2   (PETSc default)
  * "unpreconditioned" -> ||r||_2
  * "natural"          -> sqrt(r . z)

Guards mirror PETSc: r.z < 0 -> KSP_DIVERGED_INDEFINITE_PC,
p.Ap <= 0 -> KSP_DIVERGED_INDEFINITE_MAT.  Supports nonzero initial guess
(KSPSetInitialGuessNonzero contract, hdr/geneo.hpp:21-23).  Vectors stay
on their device; each iteration syncs once for the convergence test.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import common as cm


def cg_solve(matvec: Callable, b: torch.Tensor,
             pc_apply: Callable | None = None,
             x0: torch.Tensor | None = None,
             rtol: float = 1e-5, atol: float = 1e-50, dtol: float = 1e4,
             max_it: int = 10000,
             norm_type: str = "preconditioned",
             stall_its: int | None = None,
             flexible: bool = False,
             ip: cm.Inner = cm.LOCAL) -> cm.SolveResult:
    """stall_its (off by default — PETSc has no stagnation test): exit
    with CONVERGED_STEP_LENGTH when the residual norm has not improved by
    1% for `stall_its` consecutive iterations.  Used by the
    mixed-precision refinement drivers, where the f32 roundoff floor is
    problem-scaled and the f64 outer loop owns true convergence.

    flexible: Polak-Ribiere beta (flexible CG) —
    beta = z_{k+1}.(r_{k+1} - r_k) / z_k.r_k instead of Fletcher-Reeves.
    Identical for a FIXED SPD preconditioner; needed when the
    preconditioner varies between applications (inexact Schwarz: the
    structured path's PCG local solves).

    ip: the inner products (``krylov.common.Inner``); ``DistInner`` for
    vectors split across ranks."""
    if pc_apply is None:
        pc_apply = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0

    # KSPConvergedDefault rtol scale: ||M b|| (preconditioned norm, default),
    # ||b|| (unpreconditioned), sqrt(b . M b) (natural).
    if norm_type == "unpreconditioned":
        bnorm_t = ip.norm(b)
    elif norm_type == "natural":
        bnorm_t = torch.sqrt(torch.abs(ip.dot(b, pc_apply(b))))
    else:
        bnorm_t = ip.norm(pc_apply(b))

    def res_norm(r, z, rz):
        if norm_type == "unpreconditioned":
            return ip.norm(r)
        if norm_type == "natural":
            return torch.sqrt(torch.abs(rz))
        return ip.norm(z)

    r = b - matvec(x)
    z = pc_apply(r)
    rz = ip.dot(r, z)
    bnorm, rnorm0, rz_h = cm.host_scalars(bnorm_t, res_norm(r, z, rz), rz)
    hist = [rnorm0]
    reason = cm.converged_default(rnorm0, bnorm, 0, rtol, atol, dtol, max_it)
    # PETSc checks the indefinite-PC guard before the first iteration too
    if rz_h < 0.0 and reason == cm.CONVERGED_ITERATING:
        reason = cm.DIVERGED_INDEFINITE_PC

    p = z
    it = 0
    rnorm = best = rnorm0
    since = 0
    while reason == cm.CONVERGED_ITERATING:
        w = matvec(p)
        pw = ip.dot(p, w)
        alpha = rz / pw
        x = x + alpha * p
        r_old = r
        r = r - alpha * w
        z = pc_apply(r)
        rz2 = ip.dot(r, z)
        it += 1
        rnorm, pw_h, rz2_h = cm.host_scalars(res_norm(r, z, rz2), pw, rz2)
        hist.append(rnorm)
        reason = cm.converged_default(rnorm, bnorm, it, rtol, atol, dtol,
                                      max_it, rnorm0=rnorm0)
        if pw_h <= 0.0 and reason == cm.CONVERGED_ITERATING:
            reason = cm.DIVERGED_INDEFINITE_MAT
        if rz2_h < 0.0 and reason == cm.CONVERGED_ITERATING:
            reason = cm.DIVERGED_INDEFINITE_PC
        if stall_its is not None:
            # a 1% improvement resets the window: genuine convergence
            # beats this easily, a roundoff-floor bounce does not
            since = 0 if rnorm < 0.99 * best else since + 1
            best = min(best, rnorm)
            if since >= stall_its and reason == cm.CONVERGED_ITERATING:
                reason = cm.CONVERGED_STEP_LENGTH
        if flexible:
            beta = (rz2 - ip.dot(r_old, z)) / rz
        else:
            beta = rz2 / rz
        p = z + beta * p
        rz = rz2
    return cm.SolveResult(x=x, its=it, reason=reason, rnorm=rnorm,
                          history=cm.history_tensor(hist, max_it))
