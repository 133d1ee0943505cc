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

The setup-phase eigensolves run on the host in float64 LAPACK (NumPy),
where and at the precision the reference runs ARPACK/LAPACK.
"""

from __future__ import annotations

import numpy as np
import torch


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
