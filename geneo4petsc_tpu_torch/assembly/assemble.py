"""Operator assembly: the MatIS data model on PyTorch tensors.

The reference builds one local SeqAIJ block per MPI rank and aggregates them
in an unassembled global MatIS (createA, src/geneo4PETSc.cpp:643-805).  The
MatIS duality is load-bearing for GenEO: the *unassembled* local block is the
Neumann matrix; the *assembled-then-restricted* block is the Dirichlet
matrix (setUpGenEOPC, src/geneo.cpp:1692-1715).

One subdomain is one batch slot: all domains are padded to a common size
and stored as one dense [n_dom, n_max, n_max] batch.  The unassembled
(Neumann) view is the primary representation, and the global operator is

    A = sum_d R_d^T Aneu_d R_d

(exact because element sub-matrices are pre-scaled by 1/elemMult), so the
distributed SpMV is a batched dense GEMV (kernel K2, ops/local_kernels.py)
plus a scatter-add.

Padding conventions (chosen so padded slots are inert everywhere):
  * gids pad          -> n_dof (a dump slot appended to global vectors)
  * mult pad          -> 1.0   (D = 1, no-op)
  * A_neu/A_dir pad   -> identity rows/cols (factorizations stay well posed;
    pencil eigenvalues at pad slots equal 1, outside both GenEO intervals
    since tau < 1 < gamma)

The host assembly below is NumPy; ``assemble`` uploads the finished
arrays to the requested device once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_DTYPE
from ..io.element_input import ElementMesh
from ..ops.local_kernels import block_matvec
from ..partition.decompose import Decomposition, _ranges


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scatter_table(gids: np.ndarray, n_dof: int) -> np.ndarray:
    """[n_dof, max_mult] table of the flat slots (into gids.ravel()) that
    hold each global DOF, ascending; unused entries point at the extra
    zero slot ``gids.size``.  Summing a gathered row in table order is
    the deterministic scatter-add (no atomics, fixed summation order)."""
    flat = gids.ravel()
    perm = np.argsort(flat, kind="stable")
    sorted_gids = flat[perm]
    real = sorted_gids < n_dof
    perm, sorted_gids = perm[real], sorted_gids[real]
    counts = np.bincount(sorted_gids, minlength=n_dof)
    starts = np.zeros(n_dof, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    max_mult = max(int(counts.max(initial=0)), 1)
    table = np.full((n_dof, max_mult), flat.size, dtype=np.int64)
    table[sorted_gids, np.arange(len(perm)) - starts[sorted_gids]] = perm
    return table


@dataclass(frozen=True)
class SubdomainBatch:
    """Batched padded per-subdomain data (the MatIS equivalent); every
    tensor lives on one device."""

    n_dof: int
    n_dom: int
    n_max: int
    gids: torch.Tensor    # [n_dom, n_max] int64, pad = n_dof
    mask: torch.Tensor    # [n_dom, n_max] bool
    mult: torch.Tensor    # [n_dom, n_max] dtype, pad = 1
    a_neu: torch.Tensor   # [n_dom, n_max, n_max] weighted local Neumann blocks
    a_dir: torch.Tensor | None  # [n_dom, n_max, n_max] Dirichlet blocks
    scatter_idx: torch.Tensor   # [n_dof, max_mult] int64 (scatter_table)

    @property
    def device(self) -> torch.device:
        return self.a_neu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.a_neu.dtype

    @property
    def pou(self) -> torch.Tensor:
        """Partition of unity D = 1/multiplicity (createPartitionOfUnity,
        src/geneo.cpp:965-1000)."""
        return 1.0 / self.mult

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Global vector [n_dof] -> local overlapped copies [n_dom, n_max]
        (VecScatter forward/INSERT, src/geneo.cpp:1845-1869)."""
        xp = torch.cat([x, x.new_zeros(1)])
        return xp[self.gids]

    def scatter_add(self, xl: torch.Tensor) -> torch.Tensor:
        """Local copies [n_dom, n_max] -> global sum [n_dof]
        (VecScatter reverse/ADD, src/geneo.cpp:1871-1900).  Pad slots
        never enter the table; the sum order is fixed by the table, so
        the result is bit-reproducible on every device."""
        flat = torch.cat([xl.reshape(-1), xl.new_zeros(1)])
        return flat[self.scatter_idx].sum(dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Global SpMV through the unassembled blocks (MatIS MatMult)."""
        return self.scatter_add(block_matvec(self.a_neu, self.gather(x)))

    def coarse_sum(self, w: torch.Tensor) -> torch.Tensor:
        """The coarse vector Z^T x of every domain from this batch's part
        (the whole of it on one process; the multi-rank batches of
        parallel/ add the ranks' parts)."""
        return w


@dataclass
class AssembledProblem:
    """Host-side assembly products for one decomposed problem."""

    mesh: ElementMesh
    decomp: Decomposition
    batch: SubdomainBatch
    a_csr: sp.csr_matrix       # assembled global operator (host)
    nnz_loc: np.ndarray        # per-domain local nnz (reporting parity)

    @property
    def n_dof(self) -> int:
        return self.mesh.n_nodes


def _group_elems_by_size(mesh: ElementMesh):
    """Group elements by DOF count into dense [ne_k, k] / [ne_k, k, k]
    batches (vectorized assembly; elements from the reference generators
    are 1- or 2-node, but any mix of sizes is supported)."""
    sizes = np.diff(mesh.elem_ptr)
    groups = {}
    for k in np.unique(sizes):
        k = int(k)
        e_ids = np.where(sizes == k)[0]
        starts = mesh.elem_ptr[e_ids]
        idx = mesh.elem_idx[starts[:, None] + np.arange(k)[None, :]]
        if isinstance(mesh.elem_mats, np.ndarray) and mesh.elem_mats.ndim == 3:
            mats = mesh.elem_mats[e_ids]
        else:
            mats = np.stack([mesh.elem_mats[e] for e in e_ids])
        groups[k] = (e_ids, idx.astype(np.int64), mats)
    return groups


def _local_triplets(mesh: ElementMesh, decomp: Decomposition, p: int,
                    groups=None):
    """(li, lj, w_vals, nnz) triplets of domain p's WEIGHTED Neumann block
    (element sub-matrices scaled by 1/elemMult — the MatIS local block),
    vectorized over elements grouped by size."""
    nodes = decomp.dom_nodes[p]
    elems = decomp.elem_doms[p]
    if groups is None:
        groups = _group_elems_by_size(mesh)
    lis, ljs, wvals, keys = [], [], [], []
    nmax = len(nodes) + 1
    for k, (e_ids, idx, mats) in groups.items():
        # this size-group's members of the domain (both lists sorted)
        loc = np.searchsorted(e_ids, elems)
        ok = loc < len(e_ids)
        loc = loc[ok]
        gsel = loc[e_ids[loc] == elems[ok]]
        if not len(gsel):
            continue
        gdofs = idx[gsel]                       # [ne, k]
        lidx = np.searchsorted(nodes, gdofs)    # members: all nodes in dom
        w = 1.0 / decomp.elem_mult[e_ids[gsel]]
        flat_m = mats[gsel].reshape(len(gsel), -1)
        li = np.repeat(lidx, k, axis=1).ravel()   # row-major (i, j) pairs
        lj = np.tile(lidx, (1, k)).ravel()
        lis.append(li)
        ljs.append(lj)
        wvals.append((flat_m * w[:, None]).ravel())
        keys.append(li.astype(np.int64) * nmax + lj)
    if lis:
        nnz = len(np.unique(np.concatenate(keys)))
        return (np.concatenate(lis), np.concatenate(ljs),
                np.concatenate(wvals), nnz)
    z = np.zeros(0, np.int64)
    return (z, z, np.zeros(0, np.float64), 0)


def _extract_dirichlet_all(a_csr: sp.csr_matrix, decomp: Decomposition):
    """All Dirichlet blocks at once: for every assembled entry A_ij, emit
    (dom, li, lj, val) for every domain containing BOTH i and j — the
    vectorized equivalent of per-domain MatCreateSubMatrices
    (setUpGenEOPC, geneo.cpp:1697-1705), O(nnz * avg_mult * log)."""
    n = a_csr.shape[0]
    coo = a_csr.tocoo()
    rows, cols, vals = (coo.row.astype(np.int64),
                        coo.col.astype(np.int64), coo.data)

    # (dom, node) -> local index lookup via one sorted key array
    dom_sizes = decomp.dom_sizes
    dom_starts = np.zeros(decomp.n_dom + 1, np.int64)
    np.cumsum(dom_sizes, out=dom_starts[1:])
    all_keys = np.concatenate(
        [p * n + decomp.dom_nodes[p] for p in range(decomp.n_dom)]) \
        if decomp.n_dom else np.zeros(0, np.int64)

    def lookup(doms, nodes_q):
        """local index of nodes_q in domains doms, -1 if absent."""
        key = doms * n + nodes_q
        pos = np.searchsorted(all_keys, key)
        pos = np.minimum(pos, len(all_keys) - 1)
        hit = all_keys[pos] == key
        return np.where(hit, pos - dom_starts[doms], -1), hit

    # node -> domains incidence (sorted by node)
    node_doms_node = np.concatenate(
        [decomp.dom_nodes[p] for p in range(decomp.n_dom)])
    node_doms_dom = np.concatenate(
        [np.full(len(decomp.dom_nodes[p]), p, np.int64)
         for p in range(decomp.n_dom)])
    order = np.argsort(node_doms_node, kind="stable")
    nd_node = node_doms_node[order]
    nd_dom = node_doms_dom[order]
    nd_start = np.searchsorted(nd_node, np.arange(n + 1))

    # expand each entry over the domains of its ROW node
    reps = (nd_start[rows + 1] - nd_start[rows]).astype(np.int64)
    e_ids = np.repeat(np.arange(len(rows)), reps)
    offs = _ranges(reps)
    doms = nd_dom[nd_start[rows].repeat(reps) + offs]
    li, _ = lookup(doms, rows[e_ids])
    lj, hit_j = lookup(doms, cols[e_ids])
    keep = hit_j
    return doms[keep], li[keep], lj[keep], vals[e_ids][keep]


def assemble_global_csr(mesh: ElementMesh, groups=None) -> sp.csr_matrix:
    """Assembled global operator (the MatMPIAIJ view), vectorized."""
    if groups is None:
        groups = _group_elems_by_size(mesh)
    rows, cols, vals = [], [], []
    for k, (e_ids, idx, mats) in groups.items():
        rows.append(np.repeat(idx, k, axis=1).ravel())
        cols.append(np.tile(idx, (1, k)).ravel())
        vals.append(mats.reshape(len(e_ids), -1).ravel())
    a = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(mesh.n_nodes, mesh.n_nodes)).tocsr()
    a.sum_duplicates()
    return a


def batch_from_host(gids: np.ndarray, mask: np.ndarray, mult: np.ndarray,
                    a_neu: np.ndarray, a_dir: np.ndarray | None, n_dof: int,
                    device, dtype: torch.dtype = DEFAULT_DTYPE
                    ) -> SubdomainBatch:
    """Upload host arrays into a SubdomainBatch on ``device``."""
    def put(a, dt=None):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    n_dom, n_max = gids.shape
    return SubdomainBatch(
        n_dof=int(n_dof), n_dom=int(n_dom), n_max=int(n_max),
        gids=put(gids, torch.int64), mask=put(mask, torch.bool),
        mult=put(mult, dtype), a_neu=put(a_neu, dtype),
        a_dir=None if a_dir is None else put(a_dir, dtype),
        scatter_idx=put(scatter_table(np.asarray(gids), int(n_dof)),
                        torch.int64))


def assemble(mesh: ElementMesh, decomp: Decomposition, device,
             dtype: torch.dtype = DEFAULT_DTYPE, pad_to: int = 8
             ) -> AssembledProblem:
    """Build the batched subdomain data on ``device`` + the assembled
    operator on the host."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    n_dom = decomp.n_dom
    sizes = decomp.dom_sizes
    n_max = _round_up(max(int(sizes.max()), 1), pad_to)
    n_dof = mesh.n_nodes

    gids = np.full((n_dom, n_max), n_dof, dtype=np.int64)
    mask = np.zeros((n_dom, n_max), dtype=bool)
    mult = np.ones((n_dom, n_max), dtype=np_dtype)
    a_neu = np.zeros((n_dom, n_max, n_max), dtype=np_dtype)
    a_dir = np.zeros((n_dom, n_max, n_max), dtype=np_dtype)
    diag = np.arange(n_max)

    groups = _group_elems_by_size(mesh)
    a_csr = assemble_global_csr(mesh, groups)
    nnz_loc = np.zeros(n_dom, dtype=np.int64)

    for p in range(n_dom):
        nodes = decomp.dom_nodes[p]
        k = len(nodes)
        if k == 0:
            continue
        gids[p, :k] = nodes
        mask[p, :k] = True
        mult[p, :k] = decomp.node_mult[nodes]
        li, lj, wvals, nnz = _local_triplets(mesh, decomp, p, groups)
        nnz_loc[p] = nnz
        np.add.at(a_neu[p], (li, lj), wvals.astype(np_dtype, copy=False))

    # all Dirichlet blocks in one vectorized pass over the assembled entries
    d_dom, d_li, d_lj, d_val = _extract_dirichlet_all(a_csr, decomp)
    a_dir[d_dom, d_li, d_lj] = d_val.astype(np_dtype, copy=False)
    # pad-slot identity diagonal (covers empty domains too — the module's
    # documented padding invariant)
    for p in range(n_dom):
        k = len(decomp.dom_nodes[p])
        a_neu[p, diag[k:], diag[k:]] = 1.0
        a_dir[p, diag[k:], diag[k:]] = 1.0

    batch = batch_from_host(gids, mask, mult, a_neu, a_dir, n_dof, device,
                            dtype)
    return AssembledProblem(mesh=mesh, decomp=decomp, batch=batch,
                            a_csr=a_csr, nnz_loc=nnz_loc)


def robin_blocks(batch: SubdomainBatch, optim: float) -> torch.Tensor:
    """Robin = Dirichlet + optim * (border-restricted Neumann), border =
    DOFs with multiplicity > 1 (createRobinMatrix, src/geneo.cpp:1613-1670)."""
    border = (batch.mult > 1.0) & batch.mask
    sel = border[:, :, None] & border[:, None, :]
    return batch.a_dir + optim * torch.where(sel, batch.a_neu, 0.0)
