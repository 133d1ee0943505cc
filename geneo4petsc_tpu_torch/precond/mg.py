"""Algebraic multigrid preconditioner (PETSc `-pc_type mg` role).

The reference's test matrices run `-pc_type mg` as a comparison PC next to
bjacobi and the GenEO variants (tst/laplacian/laplacianRun.sh:31).  This is
an unsmoothed-aggregation AMG with a symmetric damped-Jacobi cycle (V or W,
`smooth_down` / `smooth_up` sweeps).

Design notes:
- unsmoothed aggregation makes BOTH grid-transfer operators index maps:
  restriction sums each aggregate, prolongation is one gather — no sparse
  matrix product on the device;
- each level's operator is stored as row-sorted COO, so the level SpMV is
  one gather + one per-row sum;
- both sums (the SpMV's rows and the restriction's aggregates) run through
  a precomputed [rows, max entries] table of slots (the fixed-order
  segmented reduction of assembly.assemble.scatter_table), never through
  atomics, so every apply is bit-reproducible on the card;
- the Galerkin hierarchy (P^T A P, computed once on the host with scipy)
  keeps every level SPD, and the palindromic cycle with a self-adjoint
  Jacobi smoother keeps the whole PC symmetric positive definite;
- the coarsest level is a dense Cholesky solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..assembly.assemble import scatter_table
from ..config import DEFAULT_DTYPE
from ..ops import batched_linalg as bl


def _table_sum(v: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Fixed-order segment sum: row i of the result sums v over the slots
    in ``table[i]`` (unused slots point at an appended zero)."""
    return torch.cat([v, v.new_zeros(1)])[table].sum(dim=1)


@dataclass(frozen=True)
class MGPreconditioner:
    n_levels: int              # total levels incl. the dense-coarse one
    omega: float               # Jacobi damping
    vals: tuple                # [nnz_l] per level, row-sorted COO values
    cols: tuple                # [nnz_l] int64
    row_table: tuple           # [n_l, max row nnz] slots into vals
    inv_diag: tuple            # [n_l]
    agg: tuple                 # [n_l] int64 aggregate ids, levels 0..L-2
    agg_table: tuple           # [n_{l+1}, max aggregate size] slots
    coarse_factor: torch.Tensor  # [1, n_c, n_c] Cholesky of the last level
    # -pc_mg_cycle_type {v,w} / -pc_mg_smoothdown / -pc_mg_smoothup
    # (the reference's test matrix runs mg as "w" with 5/5 sweeps,
    # tst/laplacian/laplacianRun.sh MG_OPT)
    cycle_type: str = "v"
    smooth_down: int = 1
    smooth_up: int = 1

    def _spmv(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        return _table_sum(self.vals[lvl] * x[self.cols[lvl]],
                          self.row_table[lvl])

    def _smooth(self, lvl: int, x: torch.Tensor, r: torch.Tensor,
                sweeps: int) -> torch.Tensor:
        for _ in range(sweeps):
            x = x + self.omega * self.inv_diag[lvl] * (r - self._spmv(lvl, x))
        return x

    def _cycle(self, lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == self.n_levels - 1:
            return bl.cholesky_solve(self.coarse_factor, r[None])[0]
        x = self._smooth(lvl, torch.zeros_like(r), r, self.smooth_down)
        visits = 2 if (self.cycle_type == "w"
                       and lvl + 1 < self.n_levels - 1) else 1
        for _ in range(visits):                            # V or W cycle
            res = r - self._spmv(lvl, x)
            rc = _table_sum(res, self.agg_table[lvl])      # restrict
            x = x + self._cycle(lvl + 1, rc)[self.agg[lvl]]  # correct
        return self._smooth(lvl, x, r, self.smooth_up)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, x)

    def __call__(self, x):
        return self.apply(x)


def _aggregate(a: sp.csr_matrix) -> np.ndarray:
    """Greedy root aggregation over the operator graph: every not-yet-
    aggregated node (ascending order, deterministic) becomes a root and
    absorbs its unaggregated neighbours."""
    n = a.shape[0]
    indptr, indices = a.indptr, a.indices
    agg = np.full(n, -1, np.int64)
    next_id = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]:indptr[i + 1]]
        agg[i] = next_id
        agg[nb[agg[nb] == -1]] = next_id
        next_id += 1
    return agg


def setup_mg(a_csr: sp.csr_matrix, device, dtype: torch.dtype = DEFAULT_DTYPE,
             omega: float = 2.0 / 3.0, coarse_max: int = 512,
             max_levels: int = 10, cycle_type: str = "v",
             smooth_down: int = 1, smooth_up: int = 1) -> MGPreconditioner:
    """Build the Galerkin hierarchy on the host, upload per-level COO and
    sum tables to ``device``."""
    mats = [a_csr.tocsr()]
    aggs = []
    while mats[-1].shape[0] > coarse_max and len(mats) < max_levels:
        agg = _aggregate(mats[-1])
        n_c = int(agg.max()) + 1
        if n_c >= mats[-1].shape[0]:
            break
        p = sp.csr_matrix((np.ones(len(agg)), (np.arange(len(agg)), agg)),
                          shape=(len(agg), n_c))
        mats.append((p.T @ mats[-1] @ p).tocsr())
        aggs.append(agg)

    levels = []
    for m in mats[:-1]:
        coo = m.tocoo()  # CSR->COO is row-major sorted
        levels.append((coo.data, coo.col, coo.row, 1.0 / m.diagonal()))
    dense = np.asarray(mats[-1].todense(), np.float64)
    fac = bl.cholesky_factor(torch.tensor(dense[None], dtype=dtype,
                                          device=device))
    return mg_from_levels(levels, aggs, fac, [m.shape[0] for m in mats],
                          omega=omega, cycle_type=cycle_type,
                          smooth_down=smooth_down, smooth_up=smooth_up)


def mg_from_levels(levels, aggs, coarse_factor: torch.Tensor, ns,
                   omega: float = 2.0 / 3.0, cycle_type: str = "v",
                   smooth_down: int = 1, smooth_up: int = 1
                   ) -> MGPreconditioner:
    """The preconditioner of a built hierarchy: ``levels`` holds each
    non-coarsest level's row-sorted COO (values, columns, rows) and its
    inverse diagonal as host arrays, ``aggs`` the aggregate ids of each
    transfer, ``ns`` the level sizes; uploads them and the sum tables to
    ``coarse_factor``'s device, in its dtype."""
    device, dtype = coarse_factor.device, coarse_factor.dtype

    def put(a, dt=torch.int64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return MGPreconditioner(
        n_levels=len(ns), omega=float(omega), cycle_type=cycle_type,
        smooth_down=int(smooth_down), smooth_up=int(smooth_up),
        vals=tuple(put(v, dtype) for v, _, _, _ in levels),
        cols=tuple(put(c) for _, c, _, _ in levels),
        row_table=tuple(put(scatter_table(np.asarray(r, np.int64), n))
                        for (_, _, r, _), n in zip(levels, ns)),
        inv_diag=tuple(put(d, dtype) for _, _, _, d in levels),
        agg=tuple(put(a) for a in aggs),
        agg_table=tuple(put(scatter_table(np.asarray(a, np.int64), n))
                        for a, n in zip(aggs, ns[1:])),
        coarse_factor=coarse_factor)
