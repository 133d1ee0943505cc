"""Box decomposition of a structured grid with separable multiplicities.

Domains are a gx x gy x gz grid of equal bricks; overlap L >= 1 dilates
every brick by L grid layers per axis (clipped at the grid boundary).
This is the tensor-grid specialization of the reference's decomposition
(src/geneo4PETSc.cpp:292-379):

* element membership: an axis edge belongs to every domain whose DILATED
  box contains BOTH endpoints (boxes are convex, so this is the natural
  overlapping-Schwarz assignment; L >= 1 guarantees every edge is covered,
  which is what makes A = sum_d R_d^T Aneu_d R_d exact);
* node multiplicity (partition-of-unity input, (1.25) of R1) and edge
  multiplicity (element PoU weights, geneo4PETSc.cpp:473-476) are
  SEPARABLE: products of per-axis interval counts — O(n) to compute for
  any number of domains;
* every local box is padded to the uniform dilated size (inner + 2L per
  axis); out-of-grid slots are masked (the mask-and-pad equivalent of the
  reference's empty-domain communicator shrink).

Domain id convention: d = px + gx * (py + gy * pz) — matches the halo
module's [gz, gy, gx, ...] block layout raveled.  Host NumPy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .grid import StructuredGrid


def _interval_counts(n: int, g: int, inner: int, lo_pad: int) -> np.ndarray:
    """counts[x] = number of dilated 1-D intervals [p*inner - L,
    p*inner + inner + L) (p = 0..g-1, clipped to [0, n)) containing x."""
    xs = np.arange(n)
    # interval p covers x  <=>  p*inner - L <= x < p*inner + inner + L
    # <=>  (x - inner - L) / inner < p <= (x + L) / inner
    p_hi = np.minimum((xs + lo_pad) // inner, g - 1)
    # p_lo = ceil((x - inner - L + 1) / inner), as a floor:
    p_lo = np.maximum(-((inner + lo_pad - 1 - xs) // inner), 0)
    return (p_hi - p_lo + 1).astype(np.int64)


def _edge_interval_counts(n: int, g: int, inner: int, lo_pad: int
                          ) -> np.ndarray:
    """counts[x] = number of dilated intervals containing BOTH x and x+1
    (returned length n with last slot 0)."""
    if n == 1:
        return np.zeros(1, np.int64)
    xs = np.arange(n - 1)
    p_hi = np.minimum((xs + lo_pad) // inner, g - 1)
    p_lo = np.maximum(-((inner + lo_pad - 2 - xs) // inner), 0)
    out = np.zeros(n, np.int64)
    out[:-1] = np.maximum(p_hi - p_lo + 1, 0)
    return out


@dataclass
class StructuredDecomposition:
    """Host-side decomposition metadata (all separable / O(n))."""

    grid: StructuredGrid
    dom_grid: tuple[int, int, int]    # (gx, gy, gz)
    overlap: int                      # L >= 1

    def __post_init__(self):
        nx, ny, nz = self.grid.shape
        gx, gy, gz = self.dom_grid
        if self.overlap < 1:
            raise ValueError("structured decomposition requires overlap>=1 "
                             "(edge coverage)")
        for n, g in ((nx, gx), (ny, gy), (nz, gz)):
            if n % g:
                raise ValueError(f"grid axis {n} not divisible by {g}")
            if g > 1 and self.overlap > n // g:
                raise ValueError("overlap larger than inner box size")
        self.inner = (nx // gx, ny // gy, nz // gz)
        # per-axis dilation: an undivided axis (g == 1) spans the whole
        # grid already, so no overlap padding is needed there
        self.pad = tuple(self.overlap if g > 1 else 0
                         for g in self.dom_grid)
        self.local_shape = tuple(
            i + 2 * p for i, p in zip(self.inner, self.pad))
        self.n_dom = gx * gy * gz

    # ---------------- separable multiplicity fields ----------------

    def axis_node_mult(self, axis: int) -> np.ndarray:
        n = self.grid.shape[axis]
        g = self.dom_grid[axis]
        return _interval_counts(n, g, self.inner[axis], self.pad[axis])

    def axis_edge_mult(self, axis: int) -> np.ndarray:
        n = self.grid.shape[axis]
        g = self.dom_grid[axis]
        return _edge_interval_counts(n, g, self.inner[axis], self.pad[axis])

    def node_mult(self) -> np.ndarray:
        """[nz, ny, nx] node multiplicities (partition-of-unity input)."""
        mx = self.axis_node_mult(0)
        my = self.axis_node_mult(1)
        mz = self.axis_node_mult(2)
        return (mz[:, None, None] * my[None, :, None] * mx[None, None, :])

    def edge_mult(self, axis: int) -> np.ndarray:
        """[nz, ny, nx] multiplicity of the edge (v, v+e_axis) stored at v
        (0 on the upper face)."""
        fs = [self.axis_node_mult(a) for a in range(3)]
        fs[axis] = self.axis_edge_mult(axis)
        return (fs[2][:, None, None] * fs[1][None, :, None]
                * fs[0][None, None, :])

    # ---------------- domain topology ----------------

    def dom_positions(self) -> np.ndarray:
        """[3, n_dom] domain-grid position (px, py, pz) of every domain."""
        d = np.arange(self.n_dom)
        gx, gy, _gz = self.dom_grid
        return np.stack([d % gx, (d // gx) % gy, d // (gx * gy)])

    def adjacency(self) -> np.ndarray:
        """Boolean domain-intersection adjacency (diagonal False) — the
        structured twin of partition.decompose.Decomposition.adjacency:
        two dilated boxes share nodes iff their per-axis intervals
        [p*inner - L, p*inner + inner + L) overlap, i.e.
        |delta_a| * inner_a < inner_a + 2 * pad_a on every axis."""
        rad = [(self.inner[a] + 2 * self.pad[a] - 1) // self.inner[a]
               if self.dom_grid[a] > 1 else 0 for a in range(3)]
        pos = self.dom_positions()
        adj = np.ones((self.n_dom, self.n_dom), dtype=bool)
        for a in range(3):
            delta = np.abs(pos[a][:, None] - pos[a][None, :])
            adj &= delta <= rad[a]
        np.fill_diagonal(adj, False)
        return adj

    def max_mult(self) -> np.ndarray:
        """[n_dom] max node multiplicity over each domain's real slots
        (the k of getLocalGenEOTau, src/geneo.cpp:1097-1118).  Separable:
        the max of a product field over a box is the product of per-axis
        window maxima."""
        out = np.ones(self.n_dom, np.int64)
        pos = self.dom_positions()
        for a in range(3):
            m = self.axis_node_mult(a)
            n = self.grid.shape[a]
            g = self.dom_grid[a]
            lo = np.arange(g) * self.inner[a] - self.pad[a]
            hi = lo + self.local_shape[a]
            per_pos = np.array([m[max(l, 0):min(h, n)].max()
                                for l, h in zip(lo, hi)])
            out *= per_pos[pos[a]]
        return out

    # ---------------- per-domain boxes ----------------

    def dom_pos(self, d: int) -> tuple[int, int, int]:
        gx, gy, gz = self.dom_grid
        return d % gx, (d // gx) % gy, d // (gx * gy)

    def dom_lo(self, d: int) -> tuple[int, int, int]:
        """Lower corner (may be negative: padded coordinates) of the
        uniform local box in global coords."""
        px, py, pz = self.dom_pos(d)
        return (px * self.inner[0] - self.pad[0],
                py * self.inner[1] - self.pad[1],
                pz * self.inner[2] - self.pad[2])

    def dom_nodes_mask(self, d: int) -> np.ndarray:
        """[sz, sy, sx] bool: local slots that are real grid nodes."""
        lo = self.dom_lo(d)
        sx, sy, sz = self.local_shape
        nx, ny, nz = self.grid.shape
        ax = lo[0] + np.arange(sx)
        ay = lo[1] + np.arange(sy)
        az = lo[2] + np.arange(sz)
        mx = (ax >= 0) & (ax < nx)
        my = (ay >= 0) & (ay < ny)
        mz = (az >= 0) & (az < nz)
        return mz[:, None, None] & my[None, :, None] & mx[None, None, :]

    def dom_gids(self, d: int) -> np.ndarray:
        """[sz, sy, sx] int64 global node ids (pad slots -> n_nodes)."""
        lo = self.dom_lo(d)
        sx, sy, sz = self.local_shape
        nx, ny, nz = self.grid.shape
        ax = lo[0] + np.arange(sx)
        ay = lo[1] + np.arange(sy)
        az = lo[2] + np.arange(sz)
        g = (ax[None, None, :] + nx * (ay[None, :, None]
             + ny * az[:, None, None]))
        g = np.where(self.dom_nodes_mask(d), g, self.grid.n_nodes)
        return g.astype(np.int64)

    # ---------------- generic-path adapter (testing / parity) ----------------

    def to_generic(self, mesh, ncomp: int = 1):
        """Materialize a generic partition.decompose.Decomposition with the
        SAME membership semantics (edge in domain iff both endpoints in the
        dilated box), so the dense-block path can cross-validate the
        structured operators on small grids.

        ``ncomp``: DOFs per grid node (mesh ids are then
        dof = ncomp * node + c, component fastest)."""
        from ..partition.decompose import Decomposition

        nx, ny, nz = self.grid.shape
        n_nodes = self.grid.n_nodes * ncomp

        sizes = np.diff(mesh.elem_ptr)
        elem_doms = []
        dom_nodes = []
        node_mult = np.zeros(n_nodes, np.int64)
        elem_mult = np.zeros(mesh.n_elems, np.int64)
        ids = np.arange(n_nodes) // ncomp
        cx, cy, cz = ids % nx, (ids // nx) % ny, ids // (nx * ny)
        elem_of = np.repeat(np.arange(mesh.n_elems), sizes)
        for d in range(self.n_dom):
            lo = np.array(self.dom_lo(d))
            hi = lo + np.array(self.local_shape)
            # node membership (per DOF: a dof lives where its node does)
            inbox = ((cx >= lo[0]) & (cx < hi[0]) & (cy >= lo[1])
                     & (cy < hi[1]) & (cz >= lo[2]) & (cz < hi[2]))
            # element membership: ALL its nodes in the box
            all_in = np.ones(mesh.n_elems, bool)
            np.logical_and.at(all_in, elem_of, inbox[mesh.elem_idx])
            elems = np.where(all_in)[0].astype(np.int64)
            elem_doms.append(elems)
            elem_mult[elems] += 1
            nodes = np.where(inbox)[0].astype(np.int64)
            dom_nodes.append(nodes)
            node_mult[nodes] += 1
        # pairwise intersections as LOCAL-index lists (decompose,
        # geneo4PETSc.cpp:347-376) — needed for GenEO-2's gammaLoc parity
        inter = []
        for p in range(self.n_dom):
            row = []
            for q in range(self.n_dom):
                if q == p:
                    row.append(np.zeros(0, np.int64))
                else:
                    shared = np.intersect1d(dom_nodes[p], dom_nodes[q],
                                            assume_unique=True)
                    row.append(np.searchsorted(
                        dom_nodes[p], shared).astype(np.int64))
            inter.append(row)
        return Decomposition(mesh=mesh, n_dom=self.n_dom, metis_dual=False,
                             add_overlap=self.overlap, elem_doms=elem_doms,
                             dom_nodes=dom_nodes, node_mult=node_mult,
                             elem_mult=elem_mult, intersections=inter)
