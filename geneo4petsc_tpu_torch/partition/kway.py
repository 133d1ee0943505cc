"""Deterministic k-way graph/mesh partitioner (Metis-equivalent role).

The reference partitions with METIS_PartMeshDual (element-based, nCommon=1)
or METIS_PartMeshNodal (node-based) — src/geneo4PETSc.cpp:381-445.  The
package replaces Metis with a deterministic greedy-growing + boundary-refine
k-way partitioner (same role, same dual/nodal semantics, reproducible across
runs/platforms), with a vectorized brick partition for structured grids
used by the large configurations.  A native C++ implementation of the same algorithm can
be built from native/ and is used automatically when present
(geneo4petsc_tpu_torch.partition.native).

Single-partition inputs skip partitioning entirely (reference behavior:
metis crashes on 1 part, geneo4PETSc.cpp:400-403).
"""

from __future__ import annotations

import numpy as np

from ..io.element_input import ElementMesh


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------

def node_to_elem_csr(mesh: ElementMesh) -> tuple[np.ndarray, np.ndarray]:
    """Inverse topology: node -> elements (computeInverseTopology role)."""
    counts = np.bincount(mesh.elem_idx, minlength=mesh.n_nodes)
    ptr = np.zeros(mesh.n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    idx = np.empty(ptr[-1], dtype=np.int64)
    elem_of = np.repeat(np.arange(mesh.n_elems, dtype=np.int64),
                        np.diff(mesh.elem_ptr))
    order = np.argsort(mesh.elem_idx, kind="stable")
    idx[:] = elem_of[order]
    return ptr, idx


def _edges_to_csr(n: int, u: np.ndarray, v: np.ndarray):
    """Symmetric CSR adjacency from (possibly duplicated) edge endpoints."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # dedup (src, dst) pairs
    key = src * np.int64(n) + dst
    uniq, first = np.unique(key, return_index=True)
    src, dst = src[first], dst[first]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, dst


def dual_graph(mesh: ElementMesh) -> tuple[np.ndarray, np.ndarray]:
    """Element adjacency: two elements are adjacent if they share >= 1 node
    (METIS nCommon=1 semantics)."""
    n2e_ptr, n2e_idx = node_to_elem_csr(mesh)
    us, vs = [], []
    for node in range(mesh.n_nodes):
        elems = n2e_idx[n2e_ptr[node]:n2e_ptr[node + 1]]
        if len(elems) > 1:
            # all pairs through this node
            g = np.meshgrid(elems, elems, indexing="ij")
            us.append(g[0].ravel())
            vs.append(g[1].ravel())
    if not us:
        return np.zeros(mesh.n_elems + 1, np.int64), np.zeros(0, np.int64)
    return _edges_to_csr(mesh.n_elems, np.concatenate(us), np.concatenate(vs))


def nodal_graph(mesh: ElementMesh) -> tuple[np.ndarray, np.ndarray]:
    """Node adjacency: two nodes are adjacent if they share an element."""
    us, vs = [], []
    for e in range(mesh.n_elems):
        nodes = mesh.elem_nodes(e)
        if len(nodes) > 1:
            g = np.meshgrid(nodes, nodes, indexing="ij")
            us.append(g[0].ravel())
            vs.append(g[1].ravel())
    if not us:
        return np.zeros(mesh.n_nodes + 1, np.int64), np.zeros(0, np.int64)
    return _edges_to_csr(mesh.n_nodes, np.concatenate(us), np.concatenate(vs))


# ---------------------------------------------------------------------------
# Core k-way partitioner
# ---------------------------------------------------------------------------

def _bfs_dist(ptr: np.ndarray, idx: np.ndarray, seeds: np.ndarray,
              n: int) -> np.ndarray:
    dist = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    dist[seeds] = 0
    frontier = np.asarray(seeds, dtype=np.int64)
    d = 0
    while len(frontier):
        d += 1
        nbr = _neighbors_of(ptr, idx, frontier)
        nbr = nbr[dist[nbr] > d]
        if not len(nbr):
            break
        nbr = np.unique(nbr)
        dist[nbr] = d
        frontier = nbr
    return dist


def _neighbors_of(ptr: np.ndarray, idx: np.ndarray,
                  verts: np.ndarray) -> np.ndarray:
    if not len(verts):
        return np.zeros(0, dtype=np.int64)
    starts = ptr[verts]
    ends = ptr[verts + 1]
    total = int(np.sum(ends - starts))
    out = np.empty(total, dtype=np.int64)
    pos = 0
    for s, e in zip(starts, ends):
        out[pos:pos + e - s] = idx[s:e]
        pos += e - s
    return out


def _pick_seeds(ptr: np.ndarray, idx: np.ndarray, n: int, k: int) -> np.ndarray:
    """Farthest-first k-center seeding from a pseudo-peripheral start."""
    d0 = _bfs_dist(ptr, idx, np.array([0]), n)
    d0[d0 == np.iinfo(np.int64).max] = -1
    s0 = int(np.argmax(d0))
    seeds = [s0]
    mind = _bfs_dist(ptr, idx, np.array([s0]), n)
    for _ in range(1, k):
        cand = mind.copy()
        cand[cand == np.iinfo(np.int64).max] = -1  # unreachable: avoid
        # prefer farthest reachable vertex; if graph disconnected, take an
        # unreached one to seed its component
        unreached = np.where(mind == np.iinfo(np.int64).max)[0]
        s = int(unreached[0]) if len(unreached) else int(np.argmax(cand))
        seeds.append(s)
        ds = _bfs_dist(ptr, idx, np.array([s]), n)
        mind = np.minimum(mind, ds)
    return np.asarray(seeds, dtype=np.int64)


def kway_partition(ptr: np.ndarray, idx: np.ndarray, n: int, k: int,
                   refine_passes: int = 8) -> np.ndarray:
    """Deterministic k-way partition of a CSR graph.

    Greedy multi-source BFS growth (balanced round-robin) followed by
    boundary refinement minimizing edge cut under a balance constraint.
    """
    if k <= 1 or n == 0:
        return np.zeros(n, dtype=np.int64)
    if k >= n:
        part = np.arange(n, dtype=np.int64)
        return part

    max_size = int(np.ceil(n / k * 1.03)) + 1
    part = np.full(n, -1, dtype=np.int64)
    seeds = _pick_seeds(ptr, idx, n, k)

    from collections import deque
    frontiers = [deque() for _ in range(k)]
    sizes = np.zeros(k, dtype=np.int64)
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += 1
        frontiers[p].append(int(s))

    n_assigned = int(np.sum(part >= 0))
    next_unassigned = 0
    while n_assigned < n:
        progress = False
        for p in range(k):
            if sizes[p] >= max_size:
                continue
            # pop until we can expand one vertex's unassigned neighbors
            budget = 1
            while frontiers[p] and budget > 0:
                v = frontiers[p].popleft()
                for u in idx[ptr[v]:ptr[v + 1]]:
                    if part[u] == -1:
                        part[u] = p
                        sizes[p] += 1
                        n_assigned += 1
                        frontiers[p].append(int(u))
                        budget -= 1
                        progress = True
                        if sizes[p] >= max_size or budget == 0:
                            frontiers[p].appendleft(v)
                            break
                else:
                    continue
                break
        if not progress:
            # disconnected remainder or all frontiers stalled: seed the
            # smallest part with the lowest-index unassigned vertex
            while next_unassigned < n and part[next_unassigned] != -1:
                next_unassigned += 1
            if next_unassigned >= n:
                break
            p = int(np.argmin(sizes))
            part[next_unassigned] = p
            sizes[p] += 1
            n_assigned += 1
            frontiers[p].append(next_unassigned)

    part = _refine(ptr, idx, n, k, part, sizes, max_size, refine_passes)
    return part


def _refine(ptr, idx, n, k, part, sizes, max_size, passes):
    """Greedy boundary-vertex refinement (KL/FM-style, deterministic)."""
    if n * k > 50_000_000:
        return part  # too big for the dense connectivity table; growth only
    min_size = max(1, int(np.floor(n / k * 0.97)) - 1)
    deg = np.diff(ptr)
    for _ in range(passes):
        moved = 0
        # conn[v, p] = number of neighbors of v in part p
        conn = np.zeros((n, k), dtype=np.int32)
        src = np.repeat(np.arange(n, dtype=np.int64), deg)
        np.add.at(conn, (src, part[idx]), 1)
        internal = conn[np.arange(n), part]
        boundary = np.where(internal < deg)[0]
        for v in boundary:
            p_old = part[v]
            if sizes[p_old] <= min_size:
                continue
            cv = conn[v]
            p_new = int(np.argmax(cv))
            if p_new == p_old or cv[p_new] <= cv[p_old]:
                continue
            if sizes[p_new] >= max_size:
                continue
            # apply move and update the table locally
            part[v] = p_new
            sizes[p_old] -= 1
            sizes[p_new] += 1
            nbrs = idx[ptr[v]:ptr[v + 1]]
            conn[nbrs, p_old] -= 1
            conn[nbrs, p_new] += 1
            moved += 1
        if moved == 0:
            break
    return part


# ---------------------------------------------------------------------------
# Mesh-level entry points (METIS_PartMeshDual / METIS_PartMeshNodal roles)
# ---------------------------------------------------------------------------

def partition_mesh(mesh: ElementMesh, n_parts: int, dual: bool = True,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Partition a mesh; returns (elem_part, node_part).

    dual=True: partition elements (each element in exactly one partition).
    dual=False (nodal): partition nodes (elements later join every partition
    any of their nodes is in — buildElemPartFromNodePart semantics).
    """
    if n_parts == 1:
        return (np.zeros(mesh.n_elems, np.int64), np.zeros(mesh.n_nodes, np.int64))
    try:
        from . import native
        if native.available():
            return native.partition_mesh(mesh, n_parts, dual)
    except (ImportError, OSError):
        pass
    return partition_mesh_py(mesh, n_parts, dual)


def partition_mesh_py(mesh: ElementMesh, n_parts: int, dual: bool = True,
                      ) -> tuple[np.ndarray, np.ndarray]:
    if dual:
        ptr, idx = dual_graph(mesh)
        elem_part = kway_partition(ptr, idx, mesh.n_elems, n_parts)
        # derive a node partition (first covering element wins) for debug
        node_part = np.full(mesh.n_nodes, -1, dtype=np.int64)
        for e in range(mesh.n_elems):
            for nd in mesh.elem_nodes(e):
                if node_part[nd] == -1:
                    node_part[nd] = elem_part[e]
        node_part[node_part == -1] = 0
        return elem_part, node_part
    ptr, idx = nodal_graph(mesh)
    node_part = kway_partition(ptr, idx, mesh.n_nodes, n_parts)
    # element partition in nodal mode is rebuilt per-domain downstream; give
    # the majority label for debug output only
    elem_part = np.zeros(mesh.n_elems, dtype=np.int64)
    for e in range(mesh.n_elems):
        nodes = mesh.elem_nodes(e)
        labels, counts = np.unique(node_part[nodes], return_counts=True)
        elem_part[e] = labels[np.argmax(counts)]
    return elem_part, node_part


def partition_structured_grid(shape: tuple[int, ...], grid: tuple[int, ...]
                              ) -> np.ndarray:
    """O(n) brick partition of a structured grid of nodes.

    ``shape`` = grid extents (i fastest, matching getIndex i + Ni*j + Ni*Nj*k);
    ``grid`` = number of parts along each axis.  Used by the large
    configurations, where running a graph partitioner on the host would
    dominate setup time.
    """
    axes = []
    for ext, g in zip(shape, grid):
        # balanced contiguous blocks along this axis
        bounds = np.floor(np.arange(ext, dtype=np.float64) * g / ext).astype(np.int64)
        axes.append(bounds)
    mesh_idx = np.meshgrid(*axes, indexing="ij")
    part = np.zeros_like(mesh_idx[0])
    for d in range(len(shape)):
        part = part * grid[d] + mesh_idx[d]
    # node id = i + Ni*j + Ni*Nj*k  ->  index order ('ij' with i first) must
    # be flattened with i fastest: transpose before ravel
    return part.transpose(tuple(range(len(shape) - 1, -1, -1))).ravel()
