"""General batched local solvers for the structured scale path.

The reference factors EVERY subdomain operator with MUMPS sparse LU
(directLocalSolve, src/geneo.cpp:94-124) — any sparsity, any coefficient
field.  The replacements here, in order of preference:

  1. fast diagonalization (fdm.py)    exact, O(L^2) memory — but only for
     separable kappa-derived Laplacian stencils (ASM/RAS/SRAS level 1);
  2. block-tridiagonal Schur factors (block_tridiag.py)   exact for ANY
     7-point stencil (heat, non-separable kappa, Robin blocks), O(N * s2)
     memory — feasible up to moderate plane sizes;
  3. surrogate-FDM-preconditioned batched PCG (this module)   inexact for
     ANY SPD stencil at ANY size, O(N) memory: Jacobi symmetric scaling
     strips the coefficient contrast, a separable Kronecker-sum surrogate
     (per-axis masked means of the scaled couplings) is FDM-factored
     exactly, and a few preconditioned CG iterations per apply close the
     gap.  This is inexact Schwarz: the outer Krylov pairs it with
     flexible CG (krylov/cg.py flexible=True).

``select_local_solver`` implements the policy.  Every solver exposes
``solve(x)`` on [n_dom, lz, ly, lx] or [n_dom, m, lz, ly, lx] blocks with
inert pad slots, so they are drop-in interchangeable in StructuredGenEO.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import fdm
from . import local_ops as lo
from .block_tridiag import BlockTridiagFactor, bt_factor, bt_solve
from .grid import _slices

# factor memory allowed to the exact block-tridiagonal route
BT_BUDGET_BYTES = 2e9


# ---------------- stencil algebra ----------------

def diag_congruence(st: lo.LocalStencil, d: torch.Tensor) -> lo.LocalStencil:
    """D A D for a diagonal field d [n_dom, lz, ly, lx]."""
    offs = []
    for a, c in enumerate(st.offs):
        ax = 3 - a
        if c.shape[ax] == 1:
            offs.append(c)
            continue
        lo_s, hi_s = _slices(4, ax)
        prod = torch.zeros_like(c)
        prod[lo_s] = d[lo_s] * d[hi_s]
        offs.append(c * prod)
    return lo.LocalStencil(diag=st.diag * d * d, offs=tuple(offs))


def add_scaled(a: lo.LocalStencil, b: lo.LocalStencil,
               beta) -> lo.LocalStencil:
    """A + beta * B (same sparsity pattern); ``beta`` a scalar or a
    per-domain [n_dom, 1, 1, 1] tensor."""
    return lo.LocalStencil(
        diag=a.diag + beta * b.diag,
        offs=tuple(ca + beta * cb for ca, cb in zip(a.offs, b.offs)))


# ---------------- block-tridiagonal exact solver ----------------

@dataclass(frozen=True)
class BTSolver:
    """Exact batched direct solver: block-Thomas factorization over planes
    of the longest local axis (the MUMPS replacement for non-separable
    stencils at moderate plane sizes)."""

    fac: BlockTridiagFactor
    axis: int
    local_shape: tuple

    def solve(self, x: torch.Tensor) -> torch.Tensor:
        block = x.ndim == 5
        xt = x.movedim(1, -1) if block else x
        up = bt_solve(self.fac, lo.to_planes(xt, self.axis))
        u = lo.from_planes(up, self.axis, self.local_shape)
        return u.movedim(-1, 1) if block else u


def bt_bytes(n_dom: int, local_shape, itemsize: int = 4) -> int:
    """Factor memory of the block-tridiag route (W blocks dominate)."""
    axis = lo.plane_axis(local_shape)
    p = local_shape[axis]
    s2 = math.prod(local_shape) // p
    return n_dom * p * s2 * s2 * itemsize


def bt_build(st: lo.LocalStencil, local_shape) -> BTSolver:
    """Factor a batched 7-point stencil operator exactly."""
    axis = lo.plane_axis(local_shape)
    diag_p, inplane, c = lo.plane_coefficients(st, axis)
    return BTSolver(fac=bt_factor(diag_p, inplane, c), axis=axis,
                    local_shape=tuple(local_shape))


# ---------------- surrogate FDM (Jacobi-scaled separable projection) -----

@dataclass(frozen=True)
class ScaledFDM:
    """S * FDM(surrogate)^-1 * S — a LINEAR SPD approximate inverse of a
    general stencil operator.  Used directly as the LOBPCG shift-invert
    preconditioner (only preconditioner quality matters there,
    src/geneo.cpp:635-650) and as the inner preconditioner of PCGSolver."""

    fac: fdm.FDMFactor
    scale: torch.Tensor          # [n_dom, lz, ly, lx] = 1/sqrt(diag)
    maskf: torch.Tensor

    def solve(self, x: torch.Tensor) -> torch.Tensor:
        s = lo.lift(self.scale, x)
        return self.fac.solve(x * s) * s * lo.lift(self.maskf, x)


def surrogate_fdm(st: lo.LocalStencil, maskf: torch.Tensor,
                  shift: float = 0.0) -> ScaledFDM:
    """Separable Kronecker-sum surrogate of a general SPD stencil.

    Jacobi symmetric scaling (S = diag(A)^-1/2) first: the scaled operator
    has unit diagonal and couplings bounded by diagonal dominance, so
    per-axis MASKED MEANS of the scaled couplings give 1-D tridiagonal
    operators T_a whose Kronecker sum is spectrally close to S A S even
    under high coefficient contrast.  The unit diagonal is split between
    axes proportionally to each axis's local coupling strength, which
    keeps every T_a diagonally dominant (PSD) by the triangle inequality.
    """
    dtype, dev = st.diag.dtype, st.diag.device
    n_dom = st.diag.shape[0]
    local = st.diag.shape[1:]                 # (lz, ly, lx)
    maskb = maskf > 0
    scale = torch.where(maskb, 1.0 / torch.sqrt(st.diag.abs()),
                        torch.ones_like(st.diag))
    sh = diag_congruence(st, scale)           # unit diagonal on real slots

    # per-axis coupling-strength field q_a(v) = |off up| + |off down|
    qs = []
    for a in range(3):
        ax = 3 - a
        c = sh.offs[a].abs()
        if c.shape[ax] == 1:
            qs.append(torch.zeros_like(c))
            continue
        down = torch.cat([torch.zeros_like(c.narrow(ax, 0, 1)),
                          c.narrow(ax, 0, c.shape[ax] - 1)], dim=ax)
        qs.append(c + down)
    q_tot = qs[0] + qs[1] + qs[2]
    n_active = max(sum(1 for a in range(3) if local[2 - a] > 1), 1)
    share = [torch.where(q_tot > 0, q / torch.clamp(q_tot, min=1e-30),
                         torch.full_like(q, 1.0 / n_active)) for q in qs]

    mnum = maskf
    t_diag, t_off, dd = [], [], []
    for a in range(3):
        ax = 3 - a
        ll = local[2 - a]                     # extent along axis a
        red = tuple(i for i in (1, 2, 3) if i != ax)
        msum = mnum.sum(dim=red)
        td = (share[a] * mnum).sum(dim=red) / torch.clamp(msum, min=1.0)
        td = torch.where(msum > 0, td, torch.ones_like(td))
        if ll > 1:
            lo_s, hi_s = _slices(4, ax)
            me = mnum[lo_s] * mnum[hi_s]
            cnt_e = torch.clamp(me.sum(dim=red), min=1.0)
            to = (sh.offs[a][lo_s] * me).sum(dim=red) / cnt_e
        else:
            to = torch.zeros((n_dom, 0), dtype=dtype, device=dev)
        t_diag.append(td.double().cpu().numpy())
        t_off.append(to.double().cpu().numpy())
        dd.append(np.ones((n_dom, ll)))
    ax_ops = fdm.AxisOps(t_diag=tuple(t_diag), t_off=tuple(t_off),
                         d=tuple(dd))
    fac = fdm.fdm_factor(ax_ops, shift=shift, dtype=dtype, device=dev)
    return ScaledFDM(fac=fac, scale=scale, maskf=maskf)


# ---------------- inexact PCG local solver ----------------

@dataclass(frozen=True)
class PCGSolver:
    """Inexact batched local solve: preconditioned CG on the stencil
    operator, all domains (and block columns) advanced in lockstep until
    the worst relative residual reaches ``rtol`` — the inexact-Schwarz
    replacement for MUMPS LU when both FDM and block-tridiag are out
    (non-separable operators at scale).

    ``reduce_dims``: the axes of one system (default: the box, so every
    block column is a system of its own; the elastic backend adds the
    displacement-component axis, which belongs to the system).

    ``PCGSolver.solves`` / ``PCGSolver.iterations`` count the calls of
    ``solve`` and their iterations, over every instance (a caller zeroes
    them before the run it reads).  ``start`` and ``step`` are one
    solve's pieces: ``solve`` checks the residuals on the host before
    each ``step``."""

    st: lo.LocalStencil
    pre: ScaledFDM
    maskf: torch.Tensor
    rtol: float
    max_it: int
    reduce_dims: tuple = (-3, -2, -1)
    # the domains of other ranks (krylov.common.DistInner): iterate until
    # the worst domain of every rank has converged
    ip: object = None

    solves = 0
    iterations = 0

    def _dots(self, u, v):
        return (u * v).sum(dim=self.reduce_dims, keepdim=True)

    def start(self, x: torch.Tensor):
        """(mask, squared tolerances, state (u, r, p, rz)) of a solve of
        the system with right-hand side ``x``."""
        m = lo.lift(self.maskf, x)
        b = x * m
        tiny = torch.finfo(b.dtype).tiny
        tol2 = (self.rtol * torch.clamp(self._dots(b, b).sqrt(),
                                        min=tiny)) ** 2
        p = self.pre.solve(b)
        return m, tol2, (torch.zeros_like(b), b, p, self._dots(b, p))

    def step(self, m: torch.Tensor, state):
        """One PCG iteration of every system."""
        u, r, p, rz = state
        w = self.st.matvec(p) * m
        pw = self._dots(p, w)
        alpha = torch.where(pw > 0, rz / torch.clamp(pw, min=1e-30),
                            torch.zeros_like(pw))
        u = u + alpha * p
        r = r - alpha * w
        z = self.pre.solve(r)
        rz2 = self._dots(r, z)
        beta = torch.where(rz > 0, rz2 / torch.clamp(rz, min=1e-30),
                           torch.zeros_like(rz))
        return u, r, z + beta * p, rz2

    def solve(self, x: torch.Tensor) -> torch.Tensor:
        m, tol2, state = self.start(x)

        def busy():
            r = state[1]
            b = (self._dots(r, r) > tol2).any()
            return bool(b) if self.ip is None else self.ip.any(b)

        it = 0
        while it < self.max_it and busy():
            state = self.step(m, state)
            it += 1
        PCGSolver.solves += 1
        PCGSolver.iterations += it
        return state[0] * m


# ---------------- policy ----------------

def select_local_solver(st: lo.LocalStencil, maskf: torch.Tensor,
                        local_shape, *, shift: float = 0.0,
                        rtol: float = 1e-8, max_it: int = 200,
                        bt_budget_bytes: float | None = None):
    """Exact block-tridiag when the factor fits (``bt_budget_bytes``,
    default BT_BUDGET_BYTES), inexact PCG otherwise.

    Returns (solver, exact: bool).  ``shift`` adds shift * diag(A) before
    factoring (used for shift-invert preconditioners)."""
    if bt_budget_bytes is None:
        bt_budget_bytes = BT_BUDGET_BYTES
    if shift:
        st = lo.LocalStencil(diag=st.diag * (1.0 + shift), offs=st.offs)
    n_dom = st.diag.shape[0]
    if bt_bytes(n_dom, local_shape,
                st.diag.element_size()) <= bt_budget_bytes:
        return bt_build(st, local_shape), True
    pre = surrogate_fdm(st, maskf, shift=0.0)
    return PCGSolver(st=st, pre=pre, maskf=maskf, rtol=rtol,
                     max_it=max_it), False
