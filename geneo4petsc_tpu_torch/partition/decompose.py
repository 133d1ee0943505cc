"""Domain decomposition: overlap growth, partition-of-unity multiplicities,
pairwise domain intersections.

Mirrors the reference semantics exactly (src/geneo4PETSc.cpp:196-379):

* nodal mode: an element joins partition p if ANY of its nodes is in p
  (buildElemPartFromNodePart) -> elements can belong to several domains.
* --addOverlap L: L BFS layers of neighboring elements appended per domain
  (addOverlapLayers).
* domain node sets are SORTED (canonical local ordering — the reference uses
  std::set, geneo4PETSc.cpp:339-344; local indices everywhere are positions
  in this sorted order).
* node multiplicity = number of domains containing the node — the partition
  of unity input ((1.25) of R1).
* element multiplicity = number of domains containing the element; local
  element sub-matrices are scaled by 1/elemMult (buildDomain,
  geneo4PETSc.cpp:473-476) so the unassembled domain sum reproduces A.
* intersections[p][q] = local indices (in p's sorted node set) of nodes
  shared with domain q, in ascending global order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.element_input import ElementMesh
from .kway import node_to_elem_csr


@dataclass
class Decomposition:
    """Host-side decomposition result (one entry per domain)."""

    mesh: ElementMesh
    n_dom: int
    metis_dual: bool
    add_overlap: int
    elem_doms: list    # [n_dom] sorted int64 arrays of global element ids
    dom_nodes: list    # [n_dom] sorted int64 arrays of global node ids
    node_mult: np.ndarray   # [n_nodes] int64
    elem_mult: np.ndarray   # [n_elems] int64
    intersections: list     # [n_dom][n_dom] int64 arrays of LOCAL indices
    adj: np.ndarray | None = None  # [n_dom, n_dom] bool, cached adjacency
    # non-overlapped node ownership (the metis assignment)
    node_part: np.ndarray | None = None  # [n_nodes] int64

    def adjacency(self) -> np.ndarray:
        """Boolean domain-intersection adjacency (diagonal False), derived
        from the intersection lists and cached."""
        if self.adj is None:
            n = self.n_dom
            a = np.zeros((n, n), dtype=bool)
            for p, row in enumerate(self.intersections):
                a[p] = np.fromiter(map(len, row), count=n, dtype=np.int64) > 0
            np.fill_diagonal(a, False)
            self.adj = a
        return self.adj

    @property
    def dom_sizes(self) -> np.ndarray:
        return np.array([len(d) for d in self.dom_nodes], dtype=np.int64)


def _elem_part_for(p: int, elem_part: np.ndarray, node_part: np.ndarray,
                   mesh: ElementMesh, dual: bool) -> np.ndarray:
    """Membership mask of elements in partition p (nodal lift included)."""
    if dual:
        return elem_part == p
    member = np.zeros(mesh.n_elems, dtype=bool)
    node_in_p = node_part == p
    # element belongs to p if one of its nodes does
    elem_of = np.repeat(np.arange(mesh.n_elems), np.diff(mesh.elem_ptr))
    hits = node_in_p[mesh.elem_idx]
    np.logical_or.at(member, elem_of[hits], True)
    return member


def _add_overlap(member: np.ndarray, layers: int, mesh: ElementMesh,
                 n2e_ptr: np.ndarray, n2e_idx: np.ndarray) -> np.ndarray:
    """Grow `layers` BFS layers of neighboring elements."""
    member = member.copy()
    for _ in range(layers):
        elems = np.where(member)[0]
        if not len(elems):
            break
        nodes = np.unique(np.concatenate(
            [mesh.elem_idx[mesh.elem_ptr[e]:mesh.elem_ptr[e + 1]] for e in elems]))
        nbr = np.unique(np.concatenate(
            [n2e_idx[n2e_ptr[n]:n2e_ptr[n + 1]] for n in nodes]))
        member[nbr] = True
    return member


def decompose(mesh: ElementMesh, elem_part: np.ndarray, node_part: np.ndarray,
              n_dom: int, metis_dual: bool = True, add_overlap: int = 0,
              ) -> Decomposition:
    n2e_ptr = n2e_idx = None
    if add_overlap:
        n2e_ptr, n2e_idx = node_to_elem_csr(mesh)

    elem_of = np.repeat(np.arange(mesh.n_elems), np.diff(mesh.elem_ptr))
    elem_doms: list[np.ndarray] = []
    dom_nodes: list[np.ndarray] = []
    node_mult = np.zeros(mesh.n_nodes, dtype=np.int64)
    elem_mult = np.zeros(mesh.n_elems, dtype=np.int64)

    for p in range(n_dom):
        member = _elem_part_for(p, elem_part, node_part, mesh, metis_dual)
        if add_overlap:
            member = _add_overlap(member, add_overlap, mesh, n2e_ptr, n2e_idx)
        elems = np.where(member)[0].astype(np.int64)
        elem_doms.append(elems)
        elem_mult[elems] += 1
        if len(elems):
            sel = member[elem_of]
            nodes = np.unique(mesh.elem_idx[sel]).astype(np.int64)
        else:
            nodes = np.zeros(0, dtype=np.int64)
        dom_nodes.append(nodes)
        node_mult[nodes] += 1

    intersections: list[list[np.ndarray]] = []
    adj = np.zeros((n_dom, n_dom), dtype=bool)
    for p in range(n_dom):
        row: list[np.ndarray] = []
        for q in range(n_dom):
            if p == q:
                row.append(np.zeros(0, dtype=np.int64))
                continue
            common = np.intersect1d(dom_nodes[p], dom_nodes[q],
                                    assume_unique=True)
            adj[p, q] = len(common) > 0
            row.append(np.searchsorted(dom_nodes[p], common).astype(np.int64))
        intersections.append(row)

    return Decomposition(mesh=mesh, n_dom=n_dom, metis_dual=metis_dual,
                         add_overlap=add_overlap, elem_doms=elem_doms,
                         dom_nodes=dom_nodes, node_mult=node_mult,
                         elem_mult=elem_mult, intersections=intersections,
                         adj=adj, node_part=np.asarray(node_part, np.int64))


def _ranges(sizes: np.ndarray) -> np.ndarray:
    """[0..s0-1, 0..s1-1, ...] for a vector of sizes (zero sizes allowed)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(sizes) - sizes
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)


def decompose_nodal_fast(mesh: ElementMesh, node_part: np.ndarray,
                         n_dom: int, compute_intersections: bool = False,
                         ) -> Decomposition:
    """O(n log n) vectorized decomposition for the nodal mode (element
    joins every partition containing one of its nodes) — the many-domain
    fast path used by the large configurations (the per-domain loop in
    ``decompose`` is O(n_dom * n)).

    Intersections are skipped by default (only GenEO-2's adaptive gamma
    consumes them; with thousands of domains the reference would equally
    be dominated by its O(n_dom^2) connectivity assembly).
    """
    n_elems = mesh.n_elems
    elem_of = np.repeat(np.arange(n_elems, dtype=np.int64),
                        np.diff(mesh.elem_ptr))
    node_dom = node_part[mesh.elem_idx]                 # domain per incidence
    # element-domain membership (unique pairs)
    key = elem_of * np.int64(n_dom) + node_dom
    uk = np.unique(key)
    e_of_pair = uk // n_dom
    d_of_pair = (uk % n_dom).astype(np.int64)
    elem_mult = np.bincount(e_of_pair, minlength=n_elems).astype(np.int64)
    order = np.argsort(d_of_pair, kind="stable")
    d_sorted = d_of_pair[order]
    e_sorted = e_of_pair[order]
    dom_starts = np.searchsorted(d_sorted, np.arange(n_dom + 1))
    elem_doms = [np.sort(e_sorted[dom_starts[p]:dom_starts[p + 1]])
                 for p in range(n_dom)]

    # node-domain membership: nodes of every (e, d) pair
    sizes = np.diff(mesh.elem_ptr)
    pair_sizes = sizes[e_of_pair]
    pair_nodes = mesh.elem_idx[
        mesh.elem_ptr[e_of_pair].repeat(pair_sizes)
        + _ranges(pair_sizes)]
    pair_dom = d_of_pair.repeat(pair_sizes)
    nd_key = np.unique(pair_dom * np.int64(mesh.n_nodes) + pair_nodes)
    nd_dom = (nd_key // mesh.n_nodes).astype(np.int64)
    nd_node = nd_key % mesh.n_nodes
    node_mult = np.bincount(nd_node, minlength=mesh.n_nodes).astype(np.int64)
    starts = np.searchsorted(nd_dom, np.arange(n_dom + 1))
    dom_nodes = [nd_node[starts[p]:starts[p + 1]] for p in range(n_dom)]
    # (nd_key sorted by dom then node -> per-domain node lists are sorted)

    if compute_intersections:
        inter = []
        for p in range(n_dom):
            row = []
            for q in range(n_dom):
                if p == q:
                    row.append(np.zeros(0, dtype=np.int64))
                else:
                    common = np.intersect1d(dom_nodes[p], dom_nodes[q],
                                            assume_unique=True)
                    row.append(np.searchsorted(dom_nodes[p], common))
            inter.append(row)
    else:
        inter = [[np.zeros(0, dtype=np.int64)] * n_dom
                 for _ in range(n_dom)]

    return Decomposition(mesh=mesh, n_dom=n_dom, metis_dual=False,
                         add_overlap=0, elem_doms=elem_doms,
                         dom_nodes=dom_nodes, node_mult=node_mult,
                         elem_mult=elem_mult, intersections=inter,
                         node_part=np.asarray(node_part, np.int64))


def partition_and_decompose(mesh: ElementMesh, n_dom: int,
                            metis_dual: bool = True, add_overlap: int = 0,
                            ) -> Decomposition:
    """partition + decompose (partitionAndDecompose role, minus MPI sends:
    the 'sends' are the device uploads at assembly time)."""
    from .kway import partition_mesh

    elem_part, node_part = partition_mesh(mesh, n_dom, dual=metis_dual)
    return decompose(mesh, elem_part, node_part, n_dom,
                     metis_dual=metis_dual, add_overlap=add_overlap)
