"""Restarted GMRES with PETSc KSPGMRES semantics (the reference's default
outer solver — the driver leaves KSP type at the PETSc default, gmres,
restart 30, left preconditioning, preconditioned residual norm).

Arnoldi is classical Gram-Schmidt with one re-orthogonalization pass
(CGS2) against the basis built so far, as two matrix-vector products per
pass on the device.  The Hessenberg column, the Givens rotations and the
small least-squares solve live on the host in float64: each inner step
brings the k+2 new Hessenberg entries to the host once.  The convergence
test runs on |g[k+1]| (the Givens-updated residual norm), checked at every
inner step and at each restart entry, exactly like KSPGMRESCycle.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import scipy.linalg
import torch

from . import common as cm


def gmres_solve(matvec: Callable, b: torch.Tensor,
                pc_apply: Callable | None = None,
                x0: torch.Tensor | None = None,
                rtol: float = 1e-5, atol: float = 1e-50, dtol: float = 1e4,
                max_it: int = 10000, restart: int = 30,
                norm_type: str = "preconditioned",
                ip: cm.Inner = cm.LOCAL) -> cm.SolveResult:
    """ip: the inner products (``krylov.common.Inner``); ``DistInner``
    for vectors split across ranks."""
    del norm_type  # left-preconditioned norm (PETSc gmres default)
    m = restart
    if pc_apply is None:
        pc_apply = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0

    # KSPConvergedDefault scales rtol by ||M b||_2 when the norm type is
    # preconditioned (regardless of nonzero initial guess, unless UIRNorm is
    # requested — the reference never does).
    bnorm = float(ip.norm(pc_apply(b)))

    hist: list[float] = []
    it = 0
    reason = cm.CONVERGED_ITERATING
    rnorm = rnorm0 = math.inf
    while reason == cm.CONVERGED_ITERATING:
        r = pc_apply(b - matvec(x))
        beta = float(ip.norm(r))
        if it == 0:
            rnorm0 = beta
        hist[it:] = [beta]
        reason = cm.converged_default(beta, bnorm, it, rtol, atol, dtol,
                                      max_it, rnorm0=rnorm0)
        rnorm = beta

        V = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
        if beta > 0:
            V[0] = r / beta
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        k = 0
        while k < m and reason == cm.CONVERGED_ITERATING:
            w = pc_apply(matvec(V[k]))
            wnorm0_t = ip.norm(w)
            basis = V[:k + 1]
            h1 = ip.basis_dot(basis, w)
            w = w - basis.T @ h1
            h2 = ip.basis_dot(basis, w)
            w = w - basis.T @ h2
            hk1_t = ip.norm(w)
            col_h = torch.cat([h1 + h2, hk1_t[None], wnorm0_t[None]]).tolist()
            hk1, wnorm0 = col_h[k + 1], col_h[k + 2]
            happy = hk1 <= 1e-14 * wnorm0
            if not happy and hk1 > 0:
                V[k + 1] = w / hk1

            # apply the k previous Givens rotations to the new column
            col = np.zeros(m + 1)
            col[:k + 2] = col_h[:k + 2]
            for j in range(k):
                t = cs[j] * col[j] + sn[j] * col[j + 1]
                col[j + 1] = -sn[j] * col[j] + cs[j] * col[j + 1]
                col[j] = t
            denom = math.sqrt(col[k] ** 2 + col[k + 1] ** 2)
            if denom <= 0:
                denom = 1.0
            ck = col[k] / denom
            sk = col[k + 1] / denom
            col[k] = ck * col[k] + sk * col[k + 1]
            col[k + 1] = 0.0
            cs[k], sn[k] = ck, sk
            g[k + 1] = -sk * g[k]
            g[k] = ck * g[k]
            H[:, k] = col

            it += 1
            k += 1
            rnorm = abs(g[k])
            hist[it:] = [rnorm]
            reason = cm.converged_default(rnorm, bnorm, it, rtol, atol,
                                          dtol, max_it, rnorm0=rnorm0)
            if happy and reason == cm.CONVERGED_ITERATING:
                reason = cm.CONVERGED_HAPPY_BREAKDOWN

        if k:
            # the k x k least-squares system of this cycle
            y = scipy.linalg.solve_triangular(H[:k, :k], g[:k], lower=False)
            x = x + V[:k].T @ torch.as_tensor(y, dtype=b.dtype,
                                              device=b.device)
    return cm.SolveResult(x=x, its=it, reason=reason, rnorm=rnorm,
                          history=cm.history_tensor(hist, max_it))
