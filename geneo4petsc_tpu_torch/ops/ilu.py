"""Batched ILU(0) on dense-stored blocks with a sparsity-pattern mask.

PETSc's PCBJACOBI factors each diagonal block with ILU(0) by default — the
reference's `-pc_type bjacobi` comparison PC uses exactly that.  Blocks
live as padded dense [n_blocks, n, n] tensors plus a boolean pattern
mask; the incomplete factorization is a loop over k of batched masked
rank-1 updates of the trailing block (right-looking IKJ), and the
triangular solves are loops of batched masked dot products.  Every step
is vectorized over the block axis; the sequential dimension is the
(small) block size.
"""

from __future__ import annotations

import torch


def ilu0_factor(a: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Batched ILU(0): returns the in-place LU factors (unit lower L below
    the diagonal, U on/above), restricted to ``pattern`` [b, n, n] bool."""
    n = a.shape[-1]
    acc = torch.where(pattern, a, torch.zeros_like(a))
    for k in range(n - 1):
        below = pattern[:, k + 1:, k]
        lcol = torch.where(below, acc[:, k + 1:, k] / acc[:, k, k, None],
                           torch.zeros_like(acc[:, k + 1:, k]))
        acc[:, k + 1:, k] = torch.where(below, lcol, acc[:, k + 1:, k])
        upd = lcol[:, :, None] * acc[:, k, None, k + 1:]
        acc[:, k + 1:, k + 1:] -= torch.where(pattern[:, k + 1:, k + 1:],
                                              upd, torch.zeros_like(upd))
    return acc


def ilu0_solve(lu: torch.Tensor, pattern: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Solve (L U) x = b per block [b, n] with the ILU(0) factors."""
    n = lu.shape[-1]
    lower = torch.ones(n, n, dtype=torch.bool, device=lu.device).tril(-1)
    zero = torch.zeros_like(lu)
    l_strict = torch.where(pattern & lower, lu, zero)
    u_full = torch.where(pattern & ~lower, lu, zero)
    diag = u_full.diagonal(dim1=-2, dim2=-1)
    diag = torch.where(diag != 0, diag, torch.ones_like(diag))
    y = torch.zeros_like(b)
    for i in range(n):
        y[:, i] = b[:, i] - (l_strict[:, i, :i] * y[:, :i]).sum(-1)
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[:, i] = (y[:, i] - (u_full[:, i, i + 1:] * x[:, i + 1:]).sum(-1)
                   ) / diag[:, i]
    return x
