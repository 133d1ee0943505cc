"""Batched LOBPCG for the generalized symmetric pencil A v = lambda B v.

The reference computes its GenEO eigenpairs with ARPACK shift-invert +
MUMPS inner LU (src/geneo.cpp:626-780).  Here the eigensolve is blocked
LOBPCG (Knyazev) over the whole subdomain batch at once, given only
batched block products, with a shifted inverse T ~ (A + sigma B)^-1
playing the role of the reference's shift-invert inner factorization:
``matfree_lobpcg`` for the structured scale path, whose local operators
never materialize, and ``batched_lobpcg`` for the generic path's dense
[d, n, n] pencils.

Robustness choices for ill-conditioned pencils: B-orthonormalization by
the symmetric pseudo inverse square root of the Gram matrix (instead of
Cholesky, which breaks on rank-deficient search spaces) with truncation
of dead directions, and data-scaled Ritz steering so truncated directions
sort last.  The tiny [m, m] eigendecompositions run in float64 with
``torch.linalg.eigh`` whatever the block dtype.

Layout: every block is [d, m, n] — domain, block column, point — so each
column is a contiguous vector of the domain.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import batched_linalg as bl


def _mm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[d, m, n] x [d, k, n] -> [d, m, k] (a b^T per domain)."""
    return torch.bmm(a, b.transpose(1, 2))


def _whiten_w(gram: torch.Tensor, dtype):
    """Whitening factor from the Gram matrix: (W, proj) with W the
    SYMMETRIC pseudo inverse square root V diag(e^-1/2) V^T (float64
    eigh, dead directions truncated) and proj = V diag(alive) V^T.

    The symmetric root is rotation-free (~I for a Gram ~ I), so a
    near-converged block keeps its X/W/P separation whatever rotation the
    eigensolver returns for a degenerate spectrum."""
    m = gram.shape[-1]
    gram = 0.5 * (gram + gram.transpose(-1, -2))
    e, v = torch.linalg.eigh(gram.double())
    tol = m * torch.finfo(dtype).eps * e.abs().amax(-1, keepdim=True)
    alive = e > tol
    inv_sqrt = torch.where(alive, 1.0 / torch.sqrt(torch.where(
        alive, e, torch.ones_like(e))), torch.zeros_like(e))
    w = (v * inv_sqrt[:, None, :]) @ v.transpose(-1, -2)
    proj = (v * alive[:, None, :]) @ v.transpose(-1, -2)
    return w.to(dtype), proj


def _whiten(s: torch.Tensor, bs: torch.Tensor):
    """B-orthonormalize S [d, m, n]: (W^T S, W^T BS, proj)."""
    w, proj = _whiten_w(_mm_t(s, bs), s.dtype)
    wt = w.transpose(1, 2)
    return wt @ s, wt @ bs, proj


def _rel_res(ax, bx, lam):
    """Relative residual ||Ax - lam Bx|| / (||Ax|| + (|lam|+1) ||Bx||)
    per column; the ||Bx|| term keeps the scale meaningful for exact null
    pairs (lam ~ 0, Ax ~ 0)."""
    r = ax - bx * lam[..., None]
    scale = (torch.linalg.vector_norm(ax, dim=-1)
             + (lam.abs() + 1.0) * torch.linalg.vector_norm(bx, dim=-1)
             + torch.finfo(ax.dtype).tiny)
    return r, torch.linalg.vector_norm(r, dim=-1) / scale


def matfree_lobpcg(a_op: Callable, b_op: Callable, t_op: Callable,
                   x0: torch.Tensor, max_it: int = 40, tol: float = 0.0,
                   k_monitor: int | None = None):
    """Smallest eigenpairs of the pencil (A, B) of every domain, given
    batched block products a_op/b_op and the preconditioner t_op (each
    [d, m, n] -> [d, m, n]).

    x0: [d, k, n] initial block (columns must avoid exact invariant
    subspaces; pass a masked preconditioned Gaussian block).

    tol > 0 ends the iteration as soon as every monitored relative
    residual of the current block is below tol — the SLEPc EPS tolerance
    semantics (the reference runs ARPACK at 1e-3, geneo.cpp:658); tol 0
    runs all max_it iterations.  k_monitor (default: all k columns): the
    tol exit watches only the FIRST k_monitor columns.

    Returns (w [d, k] ascending, v [d, k, n], res [d, k] relative
    residuals)."""
    k = x0.shape[1]
    k_mon = k if k_monitor is None else min(int(k_monitor), k)
    dtype = x0.dtype

    def rayleigh_ritz(s, bs):
        s, bs, proj = _whiten(s, bs)
        h = _mm_t(s, a_op(s))
        h = (0.5 * (h + h.transpose(-1, -2))).double()
        # steer the dead (truncated) subspace to the top of the spectrum
        # with a DATA-SCALED offset: eigh's backward error is
        # eps * ||h||, so a few times max|h| sorts dead directions above
        # every live value without drowning the live ones
        m = h.shape[-1]
        big = 8.0 * h.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
        h = h + big * (torch.eye(m, dtype=h.dtype, device=h.device) - proj)
        theta, c = torch.linalg.eigh(h)
        return s, c.to(dtype)

    def step(x, p):
        bx = b_op(x)
        x, bx, _ = _whiten(x, bx)
        ax = a_op(x)
        lam = (x * ax).sum(-1)
        r = ax - bx * lam[..., None]
        _, res = _rel_res(ax[:, :k_mon], bx[:, :k_mon], lam[:, :k_mon])
        s = torch.cat([x, t_op(r), p], dim=1)
        s_t, c = rayleigh_ritz(s, b_op(s))
        cx = c[..., :k]
        x_new = cx.transpose(1, 2) @ s_t
        c_wp = cx.clone()
        c_wp[:, :k, :] = 0.0
        p_new = c_wp.transpose(1, 2) @ s_t
        return x_new, p_new, res.max()

    x, p = x0, torch.zeros_like(x0)
    it = 0
    while it < max_it:
        x, p, res = step(x, p)
        it += 1
        if tol > 0.0 and not float(res) > tol:
            break

    bx = b_op(x)
    x, bx, _ = _whiten(x, bx)
    h = _mm_t(x, a_op(x))
    h = 0.5 * (h + h.transpose(-1, -2))
    theta, c = torch.linalg.eigh(h.double())
    theta, c = theta.to(dtype), c.to(dtype)
    v = c.transpose(1, 2) @ x
    _, rel = _rel_res(a_op(v), b_op(v), theta)
    return theta, v, rel


def default_start(d: int, n: int, k: int, dtype,
                  seed: int = 0) -> torch.Tensor:
    """LOBPCG start block [d, n, k]: a standard normal draw from a
    torch.Generator seeded ``seed``, on the host in float64 (the same
    numbers for every device), cast to ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((d, n, k), generator=gen,
                       dtype=torch.float64).to(dtype)


def batched_lobpcg(a: torch.Tensor, b: torch.Tensor, k: int,
                   max_it: int = 40, shift: float = 0.1,
                   x0: torch.Tensor | None = None):
    """Smallest-k eigenpairs of the batched dense pencil (A, B), both
    [d, n, n], on their device.

    Returns (w [d, k] ascending, v [d, n, k], res [d, k] relative residual
    norms).  ``shift``: sigma of the preconditioner (A + sigma B)^-1 —
    the GenEO threshold (the reference's shift-invert target region).
    Convergence is soft: max_it iterations always, residuals reported so
    callers can filter (the reference's 'good enough eigenvectors' EPS
    tolerance, geneo.cpp:658).

    ``x0`` [d, n, k]: the Gaussian start block before preconditioning
    (default: ``default_start``, a torch.Generator seeded 0).  A generic
    Gaussian block overlaps every eigendirection almost surely;
    canonical basis columns are NOT safe — they can span an exact
    invariant subspace of block-decoupled local patterns."""
    d, n, _ = a.shape
    dtype = a.dtype
    a = 0.5 * (a + a.transpose(-1, -2))
    b = 0.5 * (b + b.transpose(-1, -2))
    # shifted preconditioner factor (SPD: A PSD + sigma * B SPD), with the
    # jitter fallback for a shifted pencil that is numerically singular
    t_fac = bl.cholesky_factor(a + shift * b)

    def t_op(r):  # [d, m, n]
        return torch.cholesky_solve(r.transpose(1, 2), t_fac).transpose(1, 2)

    if x0 is None:
        x0 = default_start(d, n, k, dtype)
    x0 = t_op(x0.to(a.device, dtype).transpose(1, 2))
    # a, b symmetric: the block product of [d, m, n] columns is S A
    w, v, res = matfree_lobpcg(lambda s: s @ a, lambda s: s @ b, t_op, x0,
                               max_it=max_it)
    return w, v.transpose(1, 2), res
