"""Block-Jacobi preconditioner (PETSc PCBJACOBI role).

The reference's comparison PC (`-pc_type bjacobi`, tst/dummy/dummy.sh and
laplacianRun.sh PC matrix): one block per process over the assembled
operator's contiguous row ranges, each block factored with PETSc's default
sub-PC ILU(0).  Here the contiguous row blocks are padded to a common
size and factored as one batch: ILU(0) as batched masked rank-1 updates
(ops/ilu.py) — PETSc's sub-PC semantics — or exact batched Cholesky
(sub_type="exact", the stronger variant).  The blocks are contiguous row
ranges in order, so gathering x into blocks and writing the block
solutions back are both plain index gathers (no sums).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_DTYPE
from ..ops import batched_linalg as bl
from ..ops.ilu import ilu0_factor, ilu0_solve


@dataclass(frozen=True)
class BlockJacobiPreconditioner:
    n_dof: int
    n_blocks: int
    block_max: int
    sub_type: str                # "ilu" (PETSc default) | "exact"
    factor: torch.Tensor         # [nb, bmax, bmax] ILU(0) or Cholesky factors
    pattern: torch.Tensor | None  # [nb, bmax, bmax] bool (ilu only)
    gather_idx: torch.Tensor     # [nb, bmax] int64 rows, pad = n_dof
    take_idx: torch.Tensor       # [n_dof] int64 flat slots of the rows

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        xl = torch.cat([x, x.new_zeros(1)])[self.gather_idx]
        if self.sub_type == "ilu":
            yl = ilu0_solve(self.factor, self.pattern, xl)
        else:
            yl = bl.cholesky_solve(self.factor, xl)
        return yl.reshape(-1)[self.take_idx]

    def __call__(self, x):
        return self.apply(x)


def bjacobi_from_factors(n_dof: int, sub_type: str, factor: torch.Tensor,
                         pattern: torch.Tensor | None, sizes: np.ndarray
                         ) -> BlockJacobiPreconditioner:
    """The preconditioner of factored blocks over consecutive row ranges
    of ``sizes`` rows each (the index maps live on ``factor``'s device)."""
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    n_blocks, bmax = factor.shape[0], factor.shape[-1]
    local = np.arange(bmax)[None, :]
    valid = local < sizes[:, None]
    gather_idx = np.where(valid, starts[:, None] + local, n_dof)
    # row r of block i sits at flat slot i * bmax + (r - starts[i])
    take_idx = np.flatnonzero(valid.ravel())
    return BlockJacobiPreconditioner(
        n_dof=int(n_dof), n_blocks=int(n_blocks), block_max=int(bmax),
        sub_type=sub_type, factor=factor, pattern=pattern,
        gather_idx=torch.tensor(gather_idx, device=factor.device),
        take_idx=torch.tensor(take_idx, device=factor.device))


def setup_bjacobi(a_csr: sp.csr_matrix, n_blocks: int, device,
                  dtype: torch.dtype = DEFAULT_DTYPE,
                  sub_type: str = "ilu") -> BlockJacobiPreconditioner:
    """Split rows into n_blocks contiguous ranges (PETSc PETSC_DECIDE
    layout: even split) and factor the diagonal blocks on ``device``."""
    n = a_csr.shape[0]
    base, rem = divmod(n, n_blocks)
    sizes = np.array([base + (1 if i < rem else 0) for i in range(n_blocks)],
                     np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    bmax = int(sizes.max()) if n_blocks else 1
    blocks = np.tile(np.eye(bmax), (n_blocks, 1, 1))
    for i, (s, k) in enumerate(zip(starts, sizes)):
        blocks[i, :k, :k] = a_csr[s:s + k, s:s + k].todense()
    a = torch.tensor(blocks, dtype=dtype, device=device)
    if sub_type == "ilu":
        pattern = torch.tensor(blocks != 0.0, device=device)
        factor = ilu0_factor(a, pattern)
    else:
        pattern = None
        factor = bl.cholesky_factor(a)
    return bjacobi_from_factors(n, sub_type, factor, pattern, sizes)
