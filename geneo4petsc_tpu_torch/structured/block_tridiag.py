"""Batched block-tridiagonal Schur-complement factorization and solves.

The reference factors every subdomain operator with MUMPS sparse LU
(directLocalSolve, src/geneo.cpp:94-124).  On a tensor grid the local
operator is block-tridiagonal over planes (7-point stencil: planes couple
only to their neighbours, through a DIAGONAL coupling block), so the
direct solver is the block-Thomas / Schur recursion:

    S_0 = D_0,   S_i = D_i - C_{i-1} S_{i-1}^{-1} C_{i-1}^T

storing W_i = S_i^{-1} (dense [s2, s2], SPD).  Because C_i is diagonal
(c_i), the solve needs NO off-diagonal fill at all:

    forward   v_0 = W_0 x_0,        v_i = W_i (x_i - c_{i-1} * v_{i-1})
    backward  u_{P-1} = v_{P-1},    u_i = v_i - W_i (c_i * u_{i+1})

Every step is one batched [n_dom, s2, s2] x [n_dom, s2, k] product; the
recursions are Python loops over the planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BlockTridiagFactor:
    """w: [P, n_dom, s2, s2] Schur-complement inverses;
    c: [P-1, n_dom, s2] diagonal inter-plane couplings."""

    w: torch.Tensor
    c: torch.Tensor

    @property
    def n_planes(self) -> int:
        return self.w.shape[0]


def _plane(diag_p, inplane, i: int) -> torch.Tensor:
    """Dense plane block i [n_dom, s2, s2] from stencil coefficients."""
    d = torch.diag_embed(diag_p[:, i])
    s2 = d.shape[-1]
    for coeff, stride in inplane:
        band = torch.diag_embed(coeff[:, i, :s2 - stride], offset=stride)
        d = d + band + band.transpose(-1, -2)
    return d


def _recursion(diag_p, inplane, c, step):
    """Run ``step(i, S_i) -> S_i^-1`` over the planes of the Schur
    recursion."""
    n_dom, p, s2 = diag_p.shape
    w_prev = None
    for i in range(p):
        s = _plane(diag_p, inplane, i)
        if i > 0:
            ci = c[:, i - 1]
            s = s - (ci[:, :, None] * ci[:, None, :]) * w_prev
        w_prev = step(i, s)


def bt_factor(diag_p: torch.Tensor, inplane, c: torch.Tensor
              ) -> BlockTridiagFactor:
    """Factor the batched block-tridiagonal operator.

    diag_p:  [n_dom, P, s2] plane diagonals
    inplane: [(coeff [n_dom, P, s2], stride)] in-plane couplings
    c:       [n_dom, P-1, s2] inter-plane diagonal couplings
    """
    n_dom, p, s2 = diag_p.shape
    w_all = torch.empty((p, n_dom, s2, s2), dtype=diag_p.dtype,
                        device=diag_p.device)
    # the first plane whose Schur complement is not positive definite,
    # per domain (p: none), read back once after the recursion
    first_bad = torch.full((n_dom,), p, dtype=torch.int32,
                           device=diag_p.device)

    def step(i, s):
        fac, info = torch.linalg.cholesky_ex(s)
        first_bad.masked_fill_((info != 0) & (first_bad == p), i)
        w_all[i] = torch.cholesky_inverse(fac)
        return w_all[i]

    _recursion(diag_p, inplane, c, step)
    bad = (first_bad < p).nonzero().flatten()
    if bad.numel():
        doms = bad.tolist()
        raise ValueError(
            f"bt_factor: the operator is not positive definite: the Schur "
            f"complement of plane {first_bad[doms[0]].item()} of domain "
            f"{doms[0]} has no Cholesky factor (domains {doms})")
    return BlockTridiagFactor(w=w_all, c=c.transpose(0, 1).contiguous())


def bt_inertia(diag_p: torch.Tensor, inplane, c: torch.Tensor
               ) -> torch.Tensor:
    """Negative-eigenvalue count of a batched block-tridiagonal operator
    via the plane Schur recursion — Sylvester's law gives
    inertia(A) = sum_i inertia(S_i) (the MatGetInertia role,
    src/geneo.cpp:452-500).

    Same plane inputs as bt_factor, but the operator may be INDEFINITE
    (it is A - theta*B): each Schur complement is eigendecomposed, the
    negative eigenvalues counted, and its inverse carried through the
    recursion as V diag(1/w) V^T.  Returns [n_dom] int32 counts."""
    dtype = diag_p.dtype
    neg = torch.zeros(diag_p.shape[0], dtype=torch.int32,
                      device=diag_p.device)

    def step(i, s):
        nonlocal neg
        s = 0.5 * (s + s.transpose(-1, -2))
        w, v = torch.linalg.eigh(s)
        neg = neg + (w < 0).sum(-1, dtype=torch.int32)
        safe = torch.where(w.abs() > torch.finfo(dtype).tiny, w,
                           torch.ones_like(w))
        return (v / safe[:, None, :]) @ v.transpose(-1, -2)

    _recursion(diag_p, inplane, c, step)
    return neg


def bt_solve(fac: BlockTridiagFactor, x: torch.Tensor) -> torch.Tensor:
    """Solve A u = x; x: [n_dom, P, s2] or [n_dom, P, s2, k]."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x.unsqueeze(-1)
    p = fac.n_planes
    v = [None] * p
    for i in range(p):
        rhs = x[:, i]
        if i > 0:
            rhs = rhs - fac.c[i - 1][:, :, None] * v[i - 1]
        v[i] = fac.w[i] @ rhs
    u = [None] * p
    u[p - 1] = v[p - 1]
    for i in range(p - 2, -1, -1):
        u[i] = v[i] - fac.w[i] @ (fac.c[i][:, :, None] * u[i + 1])
    out = torch.stack(u, dim=1)
    return out.squeeze(-1) if squeeze else out
