"""Batched dense linear algebra for subdomain-local solves.

The reference delegates per-domain factorizations/solves to MUMPS (LU /
LDL^T, src/geneo.cpp:94-124, 452-500) and per-domain generalized
eigenproblems to SLEPc/ARPACK shift-invert (src/geneo.cpp:626-780), one
process at a time.  Here the subdomain axis is a batch dimension: all
domains factorize/solve together through PyTorch's batched Cholesky/LU
(cuSOLVER on the card).  Padded slots carry identity rows/cols so every
batched operation stays well posed.

MUMPS's null-pivot detection/fixing (ICNTL(24), CNTL(5)=1e20 — makes the
factorization behave like a pseudo-inverse on a singular operator) maps to
a scaled diagonal jitter fallback here.

The dense setup-phase eigensolves run on the host in float64 LAPACK
(NumPy), where and at the precision the reference runs ARPACK/LAPACK;
the Sylvester inertia counts that size the iterative (LOBPCG) route run
on the batch's device.
"""

from __future__ import annotations

import numpy as np
import torch


def require_full_f32() -> None:
    """Refuse to run with TF32 products: every float32 product of the
    float32 paths (FDM transforms, LOBPCG blocks and Gram matrices, E
    windows) must run at full float32 precision, as the JAX package's
    precision="highest"."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 solves need full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def cholesky_factor(a: torch.Tensor, jitter: bool = True) -> torch.Tensor:
    """Batched Cholesky of SPD blocks [d, n, n]; blocks whose
    factorization fails are refactored with a scaled diagonal jitter."""
    l, info = torch.linalg.cholesky_ex(a)
    if jitter:
        bad = info != 0
        if bool(bad.any()):
            scale = a.diagonal(dim1=-2, dim2=-1).abs().mean(dim=-1)
            eps = 1e3 * torch.finfo(a.dtype).eps
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            l2, _ = torch.linalg.cholesky_ex(
                a + (eps * scale)[..., None, None] * eye)
            l = torch.where(bad[..., None, None], l2, l)
    return l


def cholesky_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched triangular solves: (L L^T) x = b, L [d, n, n], b [d, n]."""
    return torch.cholesky_solve(b.unsqueeze(-1), l).squeeze(-1)


def lu_factor(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LU with partial pivoting [d, n, n]; returns (LU, pivots)
    with LAPACK's 1-based pivots."""
    return torch.linalg.lu_factor(a)


def lu_solve(lu_piv: tuple[torch.Tensor, torch.Tensor],
             b: torch.Tensor) -> torch.Tensor:
    lu, piv = lu_piv
    return torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)


def lu_factor_nullpivot(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LU with MUMPS-style null-pivot fixing (tuneSolver, geneo.cpp:76-92:
    ICNTL(24)=1 detect, CNTL(5)=1e20 fix): tiny U pivots are replaced by a
    huge value so the triangular solve contributes ~0 along numerically
    singular directions — a pseudo-inverse-like behavior that keeps a
    rank-deficient operator usable, as in the reference.  Returns
    (LU, pivots) with LAPACK's 1-based pivots."""
    lu, piv = torch.linalg.lu_factor(a)
    n = a.shape[-1]
    d = lu.diagonal(dim1=-2, dim2=-1).abs()
    tol = max(n, 10) * torch.finfo(a.dtype).eps * d.amax(-1, keepdim=True)
    lu = lu.clone()
    fixed = lu.diagonal(dim1=-2, dim2=-1)
    fixed.copy_(torch.where(d <= tol, torch.full_like(d, 1e20), fixed))
    return lu, piv


def _inertia_input(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Symmetrized S on the masked slots, pad rows/columns decoupled to
    +1 (so they factor trivially and are left out of the counts)."""
    sel = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    return (torch.where(sel, 0.5 * (s + s.transpose(-1, -2)),
                        torch.zeros_like(s))
            + (~mask)[:, :, None].to(s.dtype) * eye)


def _safe_pivot(piv: torch.Tensor) -> torch.Tensor:
    """Pivots clamped away from zero (sign kept; an exact 0 becomes +tiny)."""
    tiny = 1e-30
    return torch.where(piv.abs() > tiny, piv,
                       torch.where(piv < 0, torch.full_like(piv, -tiny),
                                   torch.full_like(piv, tiny)))


def _counts(d: torch.Tensor, mask: torch.Tensor):
    return (((d < 0) & mask).sum(-1), ((d > 0) & mask).sum(-1))


def ldlt_inertia(s: torch.Tensor, mask: torch.Tensor):
    """Inertia of symmetric S via unpivoted batched LDL^T — the MUMPS
    ICNTL/INFOG(12) route (estimateNumberOfEigenValues,
    geneo.cpp:502-560) at Cholesky cost, usable where eigvalsh is not.

    ``s``: [d, n, n] symmetric (indefinite allowed); ``mask``: [d, n]
    valid slots.  Pad rows/columns are decoupled to +1 before factoring
    and excluded from the counts.  Returns (n_neg, n_pos) per domain.

    One pivot at a time with a rank-1 update of the trailing block only
    (the JAX package updates the whole matrix under a mask; the entries
    outside the trailing block receive zero updates there): about n^3/3
    multiply-adds, not n passes over the whole matrix.

    Unpivoted LDL^T on an indefinite matrix can hit small pivots; they are
    clamped away from zero, which can miscount by one when theta falls on
    an eigenvalue — acceptable for the nev ESTIMATES this feeds (the
    reference's MUMPS inertia has the same theta-on-eigenvalue caveat)."""
    mat = _inertia_input(s, mask)
    n = mat.shape[-1]
    d = torch.empty(mat.shape[:-1], dtype=mat.dtype, device=mat.device)
    for j in range(n):
        piv = mat[:, j, j]
        d[:, j] = piv
        col = mat[:, j + 1:, j] / _safe_pivot(piv)[:, None]
        mat[:, j + 1:, j + 1:] -= col[:, :, None] * mat[:, j, None, j + 1:]
    return _counts(d, mask)


def sylvester_counts(a: torch.Tensor, b: torch.Tensor, theta: torch.Tensor,
                     mask: torch.Tensor):
    """Sylvester inertia estimate (estimateNumberOfEigenValues,
    src/geneo.cpp:502-560): inertia of S = A - theta*B on the masked slots.

    Returns (n_neg, n_pos) per domain — the counts of eigenvalues of the
    pencil (A, B) below theta / above theta — from the eigenvalues of S.
    Padded slots contribute 1 - theta (positive for tau < 1, negative for
    gamma > 1); their known contribution is subtracted."""
    sym = lambda m: 0.5 * (m + m.transpose(-1, -2))  # noqa: E731
    w = torch.linalg.eigvalsh(sym(a) - theta[:, None, None] * sym(b))
    n_pad = (~mask).sum(-1)
    neg = (w < 0).sum(-1)
    pos = (w > 0).sum(-1)
    pad_neg = (1.0 - theta) < 0
    neg = neg - torch.where(pad_neg, n_pad, torch.zeros_like(n_pad))
    pos = pos - torch.where(pad_neg, torch.zeros_like(n_pad), n_pad)
    return neg, pos


def generalized_eigh_host(a: np.ndarray, b: np.ndarray):
    """Batched symmetric-definite generalized eigensolve A v = lambda B v
    on the host (float64 LAPACK through NumPy).

    Returns (w [d, n] ascending, v [d, n, n] columns).  B = L L^T,
    C = L^-1 A L^-T, eigh(C), v = L^-T u — the dense equivalent of SLEPc's
    GHEP path."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = 0.5 * (a + a.transpose(0, 2, 1))
    b = 0.5 * (b + b.transpose(0, 2, 1))
    try:
        l = np.linalg.cholesky(b)
    except np.linalg.LinAlgError:
        scale = np.mean(np.abs(np.diagonal(b, axis1=-2, axis2=-1)),
                        axis=-1)[:, None, None]
        jit = 1e3 * np.finfo(np.float64).eps * scale
        l = np.linalg.cholesky(b + jit * np.eye(b.shape[-1]))
    y = np.linalg.solve(l, a)                         # L^-1 A
    c = np.linalg.solve(l, y.transpose(0, 2, 1))      # L^-1 A L^-T
    c = 0.5 * (c + c.transpose(0, 2, 1))
    w, u = np.linalg.eigh(c)
    v = np.linalg.solve(l.transpose(0, 2, 1), u)      # L^-T U
    return w, v


def host_eigh(a: np.ndarray):
    """Setup-phase symmetric eigendecomposition on the host via LAPACK
    (float64)."""
    a = np.asarray(a, np.float64)
    return np.linalg.eigh(0.5 * (a + a.swapaxes(-1, -2)))
