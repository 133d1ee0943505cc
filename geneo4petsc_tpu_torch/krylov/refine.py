"""Mixed-precision iterative refinement around the float32 Krylov loop.

The reference runs fully in PETSc doubles.  The scale path runs its
Krylov iterations in float32 and reaches tight tolerances (1e-8 true
residual) by outer float64 residual refinement: classic mixed-precision
IR.  Two routes:

* ``refined_solve_device`` keeps x/r/b on the device in float64 and
  computes the truth residual with one float64 operator product per
  outer pass; only two scalars reach the host per pass;
* ``refined_solve`` keeps x on the host and takes the residual from a
  host callable (the structured grid's NumPy stencil).

Both hand the inner solver the residual scaled by a power of two and
rounded to float32.  The scaling is exact in binary floating point (CG
is scale-equivariant), so it changes no bits where the unscaled
residual fits float32, and keeps 1e16-scale residuals inside its range.
The inner tolerance is floored at 1e-5 on the device route and 1e-6 on
the host route, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import common as cm
from .cg import cg_solve


def _pow2_at_least(m: torch.Tensor) -> torch.Tensor:
    """The nearest power of two >= m (1 where m == 0)."""
    s = torch.exp2(torch.ceil(torch.log2(torch.clamp(m, min=1e-30))))
    return torch.where(m > 0, s, torch.ones_like(s))


def _norm64_safe(r: torch.Tensor, ip: cm.Inner = cm.LOCAL):
    """Overflow-safe 2-norm: scale by the nearest power of two >= max|r|
    (exact in binary floating point), returning (norm, scale)."""
    s = _pow2_at_least(ip.amax(r))
    return ip.norm(r * (1.0 / s)) * s, s


def _residual64(op, b, x, ip):
    r = b - op.matvec(x)
    rn, s = _norm64_safe(r, ip)
    return r, rn, s


def _rescale_x0(b, r, x0, ip):
    """Salvage a PATHOLOGICAL initial guess (first residual >= ||b|| or
    non-finite) by the optimal line scaling alpha = argmin ||b - a A
    x0|| = <b, A x0> / ||A x0||^2, with overflow-safe scaled dots and
    A x0 recovered as b - r (no extra product).  alpha = 0 is in the
    feasible set, so the rescaled start is never worse than x = 0; if r
    itself is non-finite alpha collapses to exactly 0."""
    ax = b - r
    _, sa = _norm64_safe(ax, ip)
    _, sb = _norm64_safe(b, ip)
    axs = ax * (1.0 / sa)
    num = ip.dot(axs, b * (1.0 / sb))
    den = ip.dot(axs, axs)
    alpha = torch.where(den > 0, num / den * (sb / sa),
                        torch.zeros_like(den))
    alpha = torch.where(torch.isfinite(alpha), alpha,
                        torch.zeros_like(alpha))
    r2 = b - alpha * ax
    rn, s = _norm64_safe(r2, ip)
    return alpha * x0, r2, rn, s


def _update64(x, dx, s):
    return x + dx.to(x.dtype) * s


def _scale32(r, s):
    """(r / s) rounded to float32 — the power-of-two scaling is exact."""
    return (r * (1.0 / s)).to(torch.float32)


def make_pc_inner_solver(pc) -> Callable:
    """The float32 inner correction solve of a GenEO preconditioner for
    ``refined_solve``: ``inner(r32, rtol)`` runs CG (with ``stall_its``
    50, the float32 floor's exit) on ``pc.batch.matvec`` with
    ``pc.apply``, at most 2000 iterations.

    Efficient-hybrid contract (E variants, hdr/geneo.hpp:21-23): every
    solve must start from the deflated guess X0 = Q B — here per outer
    correction, x0 = Q r — or the simplified apply (which drops the
    (I - P^T) projection) is not equivalent to the full hybrid one."""
    eff = bool(pc.eff_hybrid)

    def inner(r32: torch.Tensor, rtol: float):
        x0 = pc.apply_q(r32).to(r32.dtype) if eff else None
        return cg_solve(pc.batch.matvec, r32, pc.apply, x0=x0, rtol=rtol,
                        max_it=2000, stall_its=50)

    return inner


@dataclass
class RefinedResult:
    x: object            # float64: a device tensor (device route) or array
    outer_its: int
    inner_its: int
    true_res: float
    converged: bool
    history: list


def _finish(x, history, best_x, best_rel, converged, outer, inner_total):
    if not converged and np.isfinite(best_rel):
        x, rel_out = best_x, best_rel
    else:
        rel_out = history[-1]
    return RefinedResult(x=x, outer_its=outer, inner_its=inner_total,
                         true_res=float(rel_out), converged=converged,
                         history=history)


def refined_solve_device(op64, b64: torch.Tensor, inner_solver: Callable,
                         tol: float = 1e-8, inner_rtol: float = 1e-5,
                         max_outer: int = 14,
                         x0: torch.Tensor | None = None,
                         ip: cm.Inner = cm.LOCAL) -> RefinedResult:
    """Device-resident mixed-precision refinement.

    x/r/b live on b64's device in float64 and the truth residual is one
    float64 ``op64.matvec`` per outer pass; the host sees two scalars a
    pass.  inner_rtol floors at 1e-5: the f32 preconditioned-residual
    floor is problem-scaled, and an unreachable inner target would burn
    the inner max_it at the floor; extra f64 outer passes are cheaper.
    ``ip``: the inner products of the vectors (``krylov.common.DistInner``
    for vectors split across ranks)."""
    b64 = b64.to(torch.float64)
    bnorm_t, bscale = _norm64_safe(b64, ip)
    bnorm = float(bnorm_t)
    x = torch.zeros_like(b64) if x0 is None else x0.to(b64.device,
                                                       torch.float64)
    inner_total = 0
    history = []
    converged = False
    best_x, best_rel = x, np.inf
    for outer in range(max_outer):
        if outer == 0 and x0 is None:
            # x = 0 -> r = b exactly: skip one truth product
            r, rel, rs = b64, 1.0, bscale
        else:
            r, rn, rs = _residual64(op64, b64, x, ip)
            rel = float(rn) / bnorm
        if outer == 0 and x0 is not None and (
                not np.isfinite(rel) or rel >= 1.0):
            # pathological deflation guess: rescale to the line optimum
            x, r, rn, rs = _rescale_x0(b64, r, x, ip)
            rel = float(rn) / bnorm
            if not np.isfinite(rel) or rel > 0.99:
                # a rescaled guess that buys < 1% is junk: restart at 0
                x = torch.zeros_like(b64)
                r, rel, rs = b64, 1.0, bscale
        history.append(rel)
        if np.isfinite(rel) and rel < best_rel:
            best_x, best_rel = x, rel
        if rel <= tol:
            converged = True
            break
        if not np.isfinite(rel):
            # the inner correction diverged hard: keep the best iterate
            break
        rtol_k = float(np.clip(0.3 * tol / rel, inner_rtol, 0.499))
        res = inner_solver(_scale32(r, rs), rtol_k)
        inner_total += int(res.its)
        x = _update64(x, res.x, rs)
    else:
        outer = max_outer
        _r, rn, _rs = _residual64(op64, b64, x, ip)
        rel = float(rn) / bnorm
        history.append(rel)
        if np.isfinite(rel) and rel < best_rel:
            best_x, best_rel = x, rel
        converged = rel <= tol
    return _finish(x, history, best_x, best_rel, converged, outer,
                   inner_total)


def refined_solve(b: np.ndarray,
                  residual64: Callable[[np.ndarray], np.ndarray],
                  inner_solver: Callable, tol: float = 1e-8,
                  inner_rtol: float = 1e-6, max_outer: int = 14,
                  x0: np.ndarray | None = None,
                  device="cpu") -> RefinedResult:
    """Solve A x = b to ||b - A x|| / ||b|| <= tol (f64 truth) with x on
    the host.

    residual64(x) -> b - A x in float64 (host); ``inner_solver(r32,
    rtol)`` is the float32 Krylov correction solve, run on ``device``."""
    b = np.asarray(b, np.float64)
    bnorm = np.linalg.norm(b)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, np.float64)
    inner_total = 0
    history = []
    converged = False
    best_x, best_rel = x, np.inf
    for outer in range(max_outer):
        r = residual64(x)
        rel = np.linalg.norm(r) / bnorm
        history.append(rel)
        if np.isfinite(rel) and rel < best_rel:
            best_x, best_rel = x, rel
        if rel <= tol:
            converged = True
            break
        if not np.isfinite(rel):
            break
        # adaptive inner tolerance: only ask the f32 solve for the
        # reduction still needed, floored at the f32 roundoff limit
        rtol_k = float(np.clip(0.3 * tol / rel, inner_rtol, 0.499))
        # the power-of-two pre-scaling of the device route, bit for bit
        rmax = float(np.max(np.abs(r)))
        rs = float(2.0 ** np.ceil(np.log2(max(rmax, 1e-30)))) \
            if rmax > 0 else 1.0
        res = inner_solver(torch.tensor(r * (1.0 / rs), dtype=torch.float32,
                                 device=device), rtol_k)
        inner_total += int(res.its)
        x = x + res.x.double().cpu().numpy() * rs
    else:
        outer = max_outer
        r = residual64(x)
        rel = np.linalg.norm(r) / bnorm
        history.append(rel)
        if np.isfinite(rel) and rel < best_rel:
            best_x, best_rel = x, rel
        converged = rel <= tol
    return _finish(x, history, best_x, best_rel, converged, outer,
                   inner_total)
