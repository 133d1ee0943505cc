"""Library embedding API — the PCGenEOSetup equivalent.

The reference has two entry paths into the GenEO PC (SURVEY.md §1): the
CLI driver, and ``PCGenEOSetup(PC, Mat ADirLoc, IS mult, IS*
intersections)`` (src/geneo.cpp:2518-2572) for external PETSc codes that
bring their own operator and decomposition metadata.  Here an external
simulation hands over its per-subdomain unassembled blocks,
local-to-global maps, multiplicities and intersections, and gets back a
preconditioner and a solve on the device it names; no mesh or
partitioner is involved.  The batch's matvec runs K2 (``block_matvec``);
under ``-dls1_type inverse_pallas`` the level-1 solve runs K1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .assembly.assemble import SubdomainBatch, _round_up, batch_from_host
from .config import GenEOOptions, KSPOptions
from .krylov import common as kcm
from .krylov.cg import cg_solve
from .krylov.gmres import gmres_solve
from .precond.geneo import GenEOPreconditioner, GenEOStats, setup_geneo


@dataclass
class _Intersections:
    """The decomposition view setup_geneo needs for GenEO-2's adaptive
    gamma: who intersects whom."""

    intersections: list
    adj: np.ndarray | None = None

    def adjacency(self) -> np.ndarray:
        if self.adj is None:
            n = len(self.intersections)
            a = np.zeros((n, n), dtype=bool)
            for p, row in enumerate(self.intersections):
                a[p] = np.fromiter(map(len, row), count=n,
                                   dtype=np.int64) > 0
            np.fill_diagonal(a, False)
            self.adj = a
        return self.adj


def make_batch(n_dof: int,
               dof_gids: list[np.ndarray],
               a_neu_blocks: list[np.ndarray],
               dof_mult: list[np.ndarray],
               a_dir_blocks: list[np.ndarray] | None = None,
               a_global=None,
               dtype: torch.dtype = torch.float64,
               pad_to: int = 8,
               device="cuda") -> SubdomainBatch:
    """Build a SubdomainBatch on ``device`` from user-provided local data.

    dof_gids[p]:     global DOF indices of domain p (ascending — the
                     reference's sorted-set local ordering contract,
                     geneo4PETSc.cpp:339-344)
    a_neu_blocks[p]: unassembled local (Neumann) matrix, PRE-WEIGHTED so
                     that sum_p R_p^T Aneu_p R_p == A (the reference's
                     1/elemMult scaling contract)
    dof_mult[p]:     DOF multiplicities in the same local order
    a_dir_blocks[p]: optional Dirichlet blocks (assembled-then-restricted);
                     derived from a_global or from the Neumann sum if absent
    a_global:        optional assembled scipy.sparse matrix

    Blocks are padded to a multiple of ``pad_to`` with identity rows."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    n_dom = len(dof_gids)
    sizes = [len(g) for g in dof_gids]
    n_max = _round_up(max(max(sizes), 1), pad_to)

    gids = np.full((n_dom, n_max), n_dof, dtype=np.int64)
    mask = np.zeros((n_dom, n_max), dtype=bool)
    mult = np.ones((n_dom, n_max), dtype=np_dtype)
    a_neu = np.tile(np.eye(n_max, dtype=np_dtype), (n_dom, 1, 1))
    a_dir = np.tile(np.eye(n_max, dtype=np_dtype), (n_dom, 1, 1))

    if a_dir_blocks is None and a_global is None:
        # derive the assembled operator from the unassembled sum
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        for p in range(n_dom):
            g = np.asarray(dof_gids[p])
            gi, gj = np.meshgrid(g, g, indexing="ij")
            rows.append(gi.ravel())
            cols.append(gj.ravel())
            vals.append(np.asarray(a_neu_blocks[p]).ravel())
        a_global = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_dof, n_dof)).tocsr()
        a_global.sum_duplicates()

    for p in range(n_dom):
        g = np.asarray(dof_gids[p])
        k = len(g)
        if k == 0:
            continue
        if not (np.diff(g) > 0).all():
            raise ValueError(
                f"domain {p}: dof_gids must be strictly ascending "
                "(sorted-set local ordering)")
        gids[p, :k] = g
        mask[p, :k] = True
        mult[p, :k] = np.asarray(dof_mult[p])
        a_neu[p, :k, :k] = np.asarray(a_neu_blocks[p])
        if a_dir_blocks is not None:
            a_dir[p, :k, :k] = np.asarray(a_dir_blocks[p])
        else:
            a_dir[p, :k, :k] = np.asarray(
                a_global[np.ix_(g, g)].todense())
    return batch_from_host(gids, mask, mult, a_neu, a_dir, n_dof,
                           torch.device(device), dtype)


def geneo_setup(batch: SubdomainBatch,
                options: GenEOOptions | None = None,
                b: np.ndarray | None = None,
                intersections: list | None = None,
                ) -> tuple[GenEOPreconditioner, GenEOStats]:
    """PCGenEOSetup equivalent: build the preconditioner from a batch, on
    the batch's device.

    ``intersections``: per-pair LOCAL-index lists (only needed for
    GenEO-2's adaptive gamma; by default every pair of domains
    intersects)."""
    options = options or GenEOOptions()
    decomp = None
    if intersections is not None:
        decomp = _Intersections(intersections=intersections)
    b_t = None if b is None else torch.as_tensor(np.asarray(b)).to(
        batch.device, batch.dtype)
    return setup_geneo(batch, options, b=b_t, decomp=decomp)


def geneo_solve(batch: SubdomainBatch, b: np.ndarray,
                pc: GenEOPreconditioner,
                ksp: KSPOptions | None = None) -> kcm.SolveResult:
    """Solve A x = b with the batch operator and a set-up preconditioner,
    from the preconditioner's initial guess, on the batch's device."""
    ksp = ksp or KSPOptions()
    b_t = torch.as_tensor(np.asarray(b)).to(batch.device, batch.dtype)
    kw = dict(rtol=ksp.rtol, atol=ksp.atol, dtol=ksp.dtol,
              max_it=ksp.max_it)
    if ksp.type == "cg":
        return cg_solve(batch.matvec, b_t, pc.apply, x0=pc.x0, **kw)
    return gmres_solve(batch.matvec, b_t, pc.apply, x0=pc.x0,
                       restart=ksp.restart, **kw)
