"""3-D linear elasticity on the structured scale backend — the problem
class of the project's baseline ("10M-DOF 3D elasticity-style SPD").

The reference handles vector-valued operators transparently: MUMPS
factors any SPD subdomain (directLocalSolve, src/geneo.cpp:94-124) and
SLEPc's eigensolves take arbitrary sparse pencils (:626-780).  This
module is the structured-grid equivalent for trilinear (Q1) hexahedral
elasticity with 3 displacement DOFs per grid node:

  * operator      — one reference 24x24 element stiffness K0(nu) scaled
    by a per-cell heterogeneous Young's modulus E(cell) (possibly
    high-contrast and NON-separable).  The matvec is the element-sum
    form: gather the 8 cell corners (static slices), one [24, 24] x
    [24, cells] product, weight by the cell modulus, add the 8 corners
    back by shifted slice adds in a fixed order — no sparse indices and
    no atomics, so repeated applies give the same bits;
  * Neumann/Dirichlet duality — Neumann = member cells weighted by
    1/cell_mult (MatIS local block, geneo4PETSc.cpp:473-476); Dirichlet =
    assembled A restricted to the box, realized by applying the cell sum
    on a one-layer-DILATED window with zero-embedded input (out-of-box
    columns vanish, out-of-grid cells carry E=0 from the halo gather);
  * local solves  — inexact surrogate-preconditioned PCG
    (structured/solvers.py): a SCALAR separable surrogate built from the
    component-traced K0 coupling constants + adjacent-cell E sums,
    Jacobi-scaled and FDM-factored, applied per displacement component;
  * GenEO-1       — matrix-free batched LOBPCG on (A_Neu, D A_Dir D),
    seeded with the six rigid-body modes of each box (3 translations + 3
    rotations), plus the high-contrast modes;
  * GenEO-2       — the (A_Neu, A_Rob) tau pencil and the swapped
    (A_Rob, D A_Dir D) gamma pencil ((19)/(21) of R4,
    src/geneo.cpp:1274-1301) with adaptive tauLoc/gammaLoc, through the
    same run_pencil conventions as the scalar backend; an exact dense
    batched-eigh route (identity-probed pencils) serves test scale;
  * E = Z^T A Z   — the scalar backend's per-offset window contractions
    (structured/geneo.py coarse_e) with a component axis, in float64.

Layouts: global vectors are [3n] node-major (dof = 3 * node + c, node
= x + nx * (y + ny * z)), or [k, 3n] blocks; local vectors are
[n_dom, 3, lz, ly, lx] (component-major, the box contiguous), and
blocks [n_dom, m, 3, lz, ly, lx], so the element product needs no
transpose.  Every float32 product runs at full float32 precision
(``require_full_f32``: no TF32).

Supported PC family: lvl1 in {ASM, RAS, SRAS, ORAS, SORAS} (Robin =
Dirichlet + optim * border-restricted Neumann, matrix-free), lvl2 in
{0, 1, H1, E1, 2, H2, E2} — the full reference matrix.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from itertools import product

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GenEOOptions
from ..krylov.cg import cg_solve
from ..ops import batched_linalg as bl
from ..ops.batched_linalg import require_full_f32
from ..ops.lobpcg import default_start, matfree_lobpcg
from ..precond.geneo import GenEOStats, _gamma_loc
from . import halo, solvers
from . import local_ops as lo
from .decompose import StructuredDecomposition
from .geneo import (LocalSchwarz, coarse_e, finalize_coarse,
                    tau_loc_structured)
from .grid import StructuredGrid

# device memory allowed to one domain chunk of the LOBPCG block applies
# and of the float64 A z products of E (the port's own byte count,
# _block_bytes)
BUDGET_BYTES = 20e9


# ===================== element =====================

def q1_hex_stiffness(e_mod: float, nu: float) -> np.ndarray:
    """24x24 stiffness of a unit Q1 hexahedron (2x2x2 Gauss), isotropic.

    Node order n = dx + 2*dy + 4*dz (corner offsets in {0,1}^3), DOF order
    (ux, uy, uz) per node: dof = 3n + c."""
    lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e_mod / (2 * (1 + nu))
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[np.arange(3), np.arange(3)] = lam + 2 * mu
    d[3:, 3:] = mu * np.eye(3)
    # corner signs in reference coords [-1, 1]^3
    xs = np.array([(-1) ** (1 + (n >> 0 & 1)) for n in range(8)], float)
    ys = np.array([(-1) ** (1 + (n >> 1 & 1)) for n in range(8)], float)
    zs = np.array([(-1) ** (1 + (n >> 2 & 1)) for n in range(8)], float)
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    k = np.zeros((24, 24))
    for xi in gp:
        for eta in gp:
            for zeta in gp:
                dn_dxi = 0.125 * xs * (1 + ys * eta) * (1 + zs * zeta)
                dn_deta = 0.125 * ys * (1 + xs * xi) * (1 + zs * zeta)
                dn_dzeta = 0.125 * zs * (1 + xs * xi) * (1 + ys * eta)
                # unit cube: J = diag(1/2), det J = 1/8
                dn = np.stack([dn_dxi, dn_deta, dn_dzeta]) * 2.0
                b = np.zeros((6, 24))
                b[0, 0::3] = dn[0]
                b[1, 1::3] = dn[1]
                b[2, 2::3] = dn[2]
                b[3, 0::3] = dn[1]
                b[3, 1::3] = dn[0]
                b[4, 1::3] = dn[2]
                b[4, 2::3] = dn[1]
                b[5, 0::3] = dn[2]
                b[5, 2::3] = dn[0]
                k += (b.T @ d @ b) / 8.0
    return 0.5 * (k + k.T)


_CORNERS = [(n & 1, (n >> 1) & 1, (n >> 2) & 1) for n in range(8)]


# ===================== problem definition =====================

@dataclass
class ElasticGrid:
    """Host-side 3-D Q1 elasticity problem on an (nx, ny, nz) node grid."""

    shape: tuple[int, int, int]
    e_cell: np.ndarray        # [nz-1, ny-1, nx-1] per-cell modulus scale
    nu: float = 0.3
    spring: float = 1.0       # clamped-face ghost spring (per DOF)

    def __post_init__(self):
        self.k0 = q1_hex_stiffness(1.0, self.nu)

    @property
    def n_nodes(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    def bc_diag(self) -> np.ndarray:
        """[nz, ny, nx] nodal ghost-spring diagonal (z = 0 face clamped —
        the reference's ghost-element Dirichlet idiom, laplacian.cpp
        boundary face, extended per displacement component)."""
        nx, ny, nz = self.shape
        d = np.zeros((nz, ny, nx))
        d[0, :, :] = self.spring
        return d

    def cell_node_field(self) -> np.ndarray:
        """Cell field embedded in a node-shaped array at the cell's lower
        corner (upper faces zero) — the form the halo gather understands."""
        nx, ny, nz = self.shape
        f = np.zeros((nz, ny, nx))
        f[: nz - 1, : ny - 1, : nx - 1] = self.e_cell
        return f

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Assembled A @ x on the host (f64 truth operator, small scale)."""
        nx, ny, nz = self.shape
        xg = np.asarray(x, np.float64).reshape(nz, ny, nx, 3)
        cz, cy, cx = nz - 1, ny - 1, nx - 1
        xc = np.stack([xg[dz:dz + cz, dy:dy + cy, dx:dx + cx]
                       for dx, dy, dz in _CORNERS], axis=3)
        v = xc.reshape(cz, cy, cx, 24)
        w = np.einsum("ij,zyxj->zyxi", self.k0, v) * self.e_cell[..., None]
        w = w.reshape(cz, cy, cx, 8, 3)
        y = np.zeros_like(xg)
        for n, (dx, dy, dz) in enumerate(_CORNERS):
            y[dz:dz + cz, dy:dy + cy, dx:dx + cx] += w[:, :, :, n]
        y += self.bc_diag()[..., None] * xg
        return y.ravel()

    def manufactured_rhs(self) -> tuple[np.ndarray, np.ndarray]:
        """(x_true, b) with x_true = (1, 2, 3, ...) — the reference's
        manufactured-solution oracle (createB, geneo4PETSc.cpp:815-834)."""
        x = np.arange(1.0, self.n_dof + 1)
        return x, self.matvec(x)


def elastic_grid(size: int, kappa_max: float = 1.0, interp: str = "",
                 nu: float = 0.3, spring: float = 1.0,
                 nonsep: bool = False, seed: int = 7) -> ElasticGrid:
    """Heterogeneous modulus field: the laplacian generator's per-axis
    profiles (separable) or non-separable spherical inclusions."""
    from ..models import _grid
    n = size
    c = n - 1
    if nonsep:
        rng = np.random.default_rng(seed)
        e = np.ones((c, c, c))
        zz, yy, xx = np.meshgrid(*([np.arange(c)] * 3), indexing="ij")
        r = max(n // 10, 1)
        for _ in range(27):
            cx, cy, cz = rng.integers(0, c, size=3)
            e[(xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2 <= r * r] \
                = kappa_max
    else:
        alpha, beta = _grid.init_kappa(n, interp, kappa_max)
        pr = np.array([_grid.compute_kappa(interp, alpha, i + 0.5, beta)
                       for i in range(c)])
        e = pr[:, None, None] * pr[None, :, None] * pr[None, None, :]
    return ElasticGrid(shape=(n, n, n), e_cell=e, nu=nu, spring=spring)


# ===================== device operators =====================

def _cell_apply(k0: torch.Tensor, cw: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Cell sum y = sum_cells cw * K0 x_cell, static slices only.

    x:  [..., 3, wz, wy, wx]; cw: [..., wz-1, wy-1, wx-1], its leading
    axes broadcastable against x's (a domain batch, a block axis).

    The 8 corners are gathered into one [..., 24, cells] operand (row
    3 * corner + component, the K0 order), multiplied by K0 in one
    product and added back corner by corner in a fixed order."""
    lead = x.shape[:-4]
    wz, wy, wx = x.shape[-3:]
    cz, cy, cx = wz - 1, wy - 1, wx - 1
    v = torch.stack([x[..., dz:dz + cz, dy:dy + cy, dx:dx + cx]
                     for dx, dy, dz in _CORNERS], dim=-5)
    w = torch.matmul(k0, v.reshape(lead + (24, cz * cy * cx)))
    w = w.reshape(lead + (8, 3, cz, cy, cx)) * cw[..., None, None, :, :, :]
    y = torch.zeros_like(x)
    for n, (dx, dy, dz) in enumerate(_CORNERS):
        y[..., dz:dz + cz, dy:dy + cy, dx:dx + cx] += w[..., n, :, :, :, :]
    return y


def _cell_bytes(shape, itemsize: int) -> int:
    """Temporaries of one _cell_apply on x of ``shape`` [..., 3, wz, wy,
    wx]: the gathered corners and the product ([..., 24, cells] each),
    the output."""
    lead = int(np.prod(shape[:-4], dtype=np.int64))
    wz, wy, wx = shape[-3:]
    cells = (wz - 1) * (wy - 1) * (wx - 1)
    return lead * itemsize * (2 * 24 * cells + 3 * wz * wy * wx)


def _lift(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-domain field [n_dom, ...] viewed at the rank of x [n_dom,
    (m,) 3, ...]: unit axes for the block and component axes."""
    extra = x.ndim - f.ndim
    return f.reshape(f.shape[:1] + (1,) * extra + f.shape[1:])


@dataclass(frozen=True)
class ElasticOp:
    """Assembled global operator (iteration-phase SpMV on flat [3n]
    vectors or [k, 3n] blocks — the distributed MatMult role).

    ``budget_bytes`` (None: one pass): cut the cell sum into z slabs so
    that the temporaries of each stay within it; the layer between two
    slabs receives both slabs' sums, in slab order.  The product runs in
    the operator's dtype and is returned in the input's (a float64
    operator serves float32 Krylov vectors, see solve_elastic)."""

    e_cell: torch.Tensor      # [nz-1, ny-1, nx-1]
    k0: torch.Tensor          # [24, 24]
    bc: torch.Tensor          # [nz, ny, nx] nodal spring diagonal
    grid_shape: tuple
    budget_bytes: float | None = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = self.grid_shape
        lead = x.shape[:-1]
        xg = x.to(self.k0.dtype).reshape(lead + (nz, ny, nx, 3)) \
            .movedim(-1, -4)
        cz = nz - 1
        step = cz
        if self.budget_bytes is not None:
            per_layer = _cell_bytes(lead + (3, 2, ny, nx),
                                    self.k0.element_size())
            step = int(np.clip(self.budget_bytes // per_layer, 1, cz))
        if step >= cz:
            y = _cell_apply(self.k0, self.e_cell, xg)
        else:
            y = torch.zeros_like(xg)
            for z0 in range(0, cz, step):
                z1 = min(z0 + step, cz)
                y[..., z0:z1 + 1, :, :] += _cell_apply(
                    self.k0, self.e_cell[z0:z1], xg[..., z0:z1 + 1, :, :])
        y = y + self.bc * xg
        return y.movedim(-4, -1).reshape(x.shape).to(x.dtype)


def elastic_op(g: ElasticGrid, dtype=torch.float32, device="cuda",
               budget_bytes: float | None = None) -> ElasticOp:
    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return ElasticOp(e_cell=put(g.e_cell), k0=put(g.k0), bc=put(g.bc_diag()),
                     grid_shape=tuple(g.shape), budget_bytes=budget_bytes)


@dataclass(frozen=True)
class LocalElastic:
    """Batched local cell-sum operator on (optionally dilated) windows.

    cw:       [n_dom, wz-1, wy-1, wx-1] per-cell weights (0 = excluded)
    diag_add: [n_dom, wz, wy, wx] nodal diagonal (ghost springs)
    pads:     per-array-axis (z, y, x) embedding pads — nonzero means
              matvec inputs are the INNER window and the operator embeds
              them into the dilated window with zeros (the assembled-
              restricted Dirichlet semantics, src/geneo.cpp:1697-1705).
    matvec takes [n_dom, 3, ...] vectors and [n_dom, m, 3, ...] blocks.
    """

    cw: torch.Tensor
    k0: torch.Tensor
    diag_add: torch.Tensor
    pads: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        pz, py, px = self.pads
        embed = any(self.pads)
        xe = F.pad(x, (px, px, py, py, pz, pz)) if embed else x
        cw = self.cw if xe.ndim == 5 else self.cw.unsqueeze(1)
        y = _cell_apply(self.k0, cw, xe)
        y = y + _lift(self.diag_add, xe) * xe
        if embed:
            wz, wy, wx = y.shape[-3:]
            y = y[..., pz:wz - pz, py:wy - py, px:wx - px]
        return y


@dataclass(frozen=True)
class PouSandwich:
    """D A D for a nodal field d (broadcast over components)."""

    op: object
    d: torch.Tensor            # [n_dom, wz, wy, wx]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        d = _lift(self.d, x)
        return d * self.op.matvec(d * x)


@dataclass(frozen=True)
class RobinOp:
    """Dirichlet + optim * (R_border A_Neu R_border) — the ORAS/SORAS
    Robin operator matrix-free (createRobinMatrix, geneo.cpp:1613-1670)."""

    dir_op: object
    neu_op: object
    border: torch.Tensor       # [n_dom, wz, wy, wx] 0/1 nodal mask
    optim: torch.Tensor

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        b = _lift(self.border, x)
        return self.dir_op.matvec(x) + self.optim * b * \
            self.neu_op.matvec(b * x)


@dataclass(frozen=True)
class VecFDM:
    """Apply a scalar ScaledFDM per displacement component (the
    component-decoupled surrogate preconditioner)."""

    fdm: solvers.ScaledFDM

    def solve(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:                       # [d, 3, wz, wy, wx]
            return self.fdm.solve(x)          # components as columns
        # [d, m, 3, wz, wy, wx] -> fold (m, 3) into columns
        d, m, c = x.shape[:3]
        y = self.fdm.solve(x.reshape((d, m * c) + x.shape[3:]))
        return y.reshape(x.shape)


def _surrogate_constants(k0: np.ndarray) -> tuple[float, list]:
    """(d0, t): the diagonal constant tr(K0)/24 per (node, cell)
    incidence, and per axis a the mean over the 4 axis-a node pairs of
    (1/3) sum_c K0[(n1,c),(n2,c)]."""
    k0 = np.asarray(k0, np.float64)
    d0 = float(np.trace(k0)) / 24.0
    t = []
    for a in range(3):
        vals = []
        for n1, (dx, dy, dz) in enumerate(_CORNERS):
            off = [dx, dy, dz]
            if off[a] == 1:
                continue
            off[a] = 1
            n2 = off[0] + 2 * off[1] + 4 * off[2]
            vals.append(sum(k0[3 * n1 + c, 3 * n2 + c]
                            for c in range(3)) / 3.0)
        t.append(float(np.mean(vals)))
    return d0, t


def surrogate_stencil(k0: np.ndarray, cw: torch.Tensor,
                      diag_add: torch.Tensor,
                      maskf: torch.Tensor) -> lo.LocalStencil:
    """The scalar 7-point stencil that stands in for the (weighted)
    elasticity operator: d0 * (adjacent-cell weight sums) + diag_add on
    the diagonal, t_a * (edge-sharing-cell weight sums) on the axis-a
    edges — pure shifted adds on the cell-weight field; pad slots get a
    unit diagonal and no couplings."""
    d0, t = _surrogate_constants(k0)
    n_dom, wz, wy, wx = maskf.shape

    def cell_sum(arr, sums_axes):
        """Sum the cell field over corners along the given axes -> node
        field: each node sums cells at offsets {-1, 0} along summed axes,
        {0} along kept axes (the cell array is one shorter per axis and
        aligned at the lower corner; zero padding handles faces)."""
        out = None
        offs = [([0, 1] if ax in sums_axes else [0]) for ax in (1, 2, 3)]
        ae = F.pad(arr, (1, 1, 1, 1, 1, 1))
        for oz, oy, ox in product(*offs):
            piece = ae[:, 1 - oz:1 - oz + wz, 1 - oy:1 - oy + wy,
                       1 - ox:1 - ox + wx]
            out = piece if out is None else out + piece
        return out

    diag = d0 * cell_sum(cw, {1, 2, 3}) + diag_add
    offs = []
    for a in range(3):
        ax = 3 - a
        off = t[a] * cell_sum(cw, {1, 2, 3} - {ax})   # at the lower node
        # zero the upper face (no edge beyond the window)
        off.narrow(ax, off.shape[ax] - 1, 1).zero_()
        offs.append(off)
    real = maskf > 0
    diag = torch.where(real, torch.clamp(diag, min=1e-30),
                       torch.ones_like(diag))
    offs = [torch.where(real, o, torch.zeros_like(o)) for o in offs]
    return lo.LocalStencil(diag=diag, offs=tuple(offs))


def _scalar_surrogate(k0: np.ndarray, cw: torch.Tensor,
                      diag_add: torch.Tensor, maskf: torch.Tensor,
                      shift: float) -> VecFDM:
    """Scalar separable surrogate of the (weighted) elasticity operator,
    FDM-factored and applied per component (solvers.surrogate_fdm)."""
    st = surrogate_stencil(k0, cw, diag_add, maskf)
    return VecFDM(solvers.surrogate_fdm(st, maskf, shift=shift))


# ===================== preconditioner =====================

@dataclass(frozen=True)
class ElasticGenEO(LocalSchwarz):
    """The vector-DOF twin of StructuredGenEO: same applyGenEOPC
    semantics (src/geneo.cpp:2051-2098) on [n_dom, 3, lz, ly, lx]
    component fields; the coarse basis is [n_dom, k_max, 3, lz, ly,
    lx]."""

    grid_shape: tuple
    dom_grid: tuple
    pad: tuple
    local_shape: tuple
    lvl1: str
    lvl2: int
    hybrid: bool
    eff_hybrid: bool
    dim_e: int
    k_max: int
    gop: ElasticOp
    l1: object                   # local solver (.solve on [d, 3, ...])
    pou: torch.Tensor            # [d, lz, ly, lx] nodal partition of unity
    maskf: torch.Tensor          # [d, lz, ly, lx]
    z: torch.Tensor | None       # [d, k_max, 3, lz, ly, lx]
    colids: torch.Tensor | None  # [d, k_max] int64 (pad -> dim_e)
    col_sel: torch.Tensor | None  # flat positions of the real colids
    e_evecs: torch.Tensor | None
    e_eig_inv: torch.Tensor | None
    x0: torch.Tensor             # [3n]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return halo.to_batch(halo.halo_gather(
            x.reshape(-1, 3).T, self.grid_shape, self.dom_grid, self.pad))

    def _scatter(self, xb: torch.Tensor) -> torch.Tensor:
        y = halo.halo_scatter_add(
            halo.from_batch(xb, self.dom_grid), self.grid_shape,
            self.dom_grid, self.pad)
        return y.T.reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.gop.matvec(x)


# ===================== setup =====================

def _domains(tree, lo_i: int, hi_i: int):
    """Domains [lo_i, hi_i) of an operator tree: every tensor of it has
    a leading domain axis but the element stiffness ``k0`` and 0-d
    scalars."""
    if isinstance(tree, torch.Tensor):
        return tree[lo_i:hi_i] if tree.ndim else tree
    if isinstance(tree, tuple):
        return tuple(_domains(v, lo_i, hi_i) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _domains(getattr(tree, f.name), lo_i, hi_i)
            for f in dataclasses.fields(tree) if f.name != "k0"})
    return tree


def _gather_stack(raw: torch.Tensor, grid_shape, dom_grid, pad):
    """[F, N] stacked global fields -> F+1 batched local boxes (the last
    the gathered ones mask)."""
    ones = torch.ones((1, raw.shape[1]), dtype=raw.dtype, device=raw.device)
    b = halo.to_batch(halo.halo_gather(torch.cat([raw, ones]), grid_shape,
                                       dom_grid, pad))
    return [b[:, i] for i in range(raw.shape[0] + 1)]


def _geom(g: ElasticGrid, dom_grid, overlap) -> StructuredDecomposition:
    """Node-grid box decomposition (geometry only; kappa unused)."""
    nx, ny, nz = g.shape
    gg = StructuredGrid(shape=g.shape, kappa=np.ones((nz, ny, nx)), dim=3)
    return StructuredDecomposition(gg, tuple(dom_grid), overlap)


def rigid_modes(local_shape) -> np.ndarray:
    """[6, 3, sz, sy, sx] — the six rigid-body modes (3 translations + 3
    rotations about the window center) of a local box.  They are EXACT
    null vectors of floating Neumann blocks (K0 annihilates linearized
    rigid fields), so seeding the LOBPCG search block with them locks the
    near-kernel at once; a random block needs many iterations to dig
    them out through the scalar surrogate preconditioner."""
    sx, sy, sz = local_shape
    zz = np.arange(sz) - (sz - 1) / 2.0
    yy = np.arange(sy) - (sy - 1) / 2.0
    xx = np.arange(sx) - (sx - 1) / 2.0
    z3, y3, x3 = np.meshgrid(zz, yy, xx, indexing="ij")
    scale = max(sx, sy, sz)
    z3, y3, x3 = z3 / scale, y3 / scale, x3 / scale
    cols = np.zeros((6, 3, sz, sy, sx))
    cols[0, 0] = cols[1, 1] = cols[2, 2] = 1.0     # t_x, t_y, t_z
    cols[3, 0], cols[3, 1] = -y3, x3               # r_z
    cols[4, 1], cols[4, 2] = -z3, y3               # r_x
    cols[5, 0], cols[5, 2] = z3, -x3               # r_y
    return cols


def _block_bytes(local_shape, dilated: bool, itemsize: int) -> int:
    """Device bytes one block column of one domain costs in a LOBPCG
    run: the cell apply on the (dilated) window plus ~16 block panels of
    the LOBPCG recurrence."""
    sx, sy, sz = local_shape
    w = (sz + 2, sy + 2, sx + 2) if dilated else (sz, sy, sx)
    return _cell_bytes((3,) + w, itemsize) + 16 * 3 * sx * sy * sz \
        * itemsize


def setup_elastic(g: ElasticGrid, dom_grid, overlap: int,
                  opts: GenEOOptions, b: torch.Tensor | None = None,
                  dtype=torch.float32, timers=None, device="cuda",
                  lobpcg_start=None,
                  budget_bytes: float = BUDGET_BYTES
                  ) -> tuple[ElasticGenEO, GenEOStats]:
    """Structured setUpGenEOPC for 3-D Q1 elasticity, on ``device``
    except the host float64 work (the dense route's eigh, the coarse
    factorization).

    ``lobpcg_start(d, n_loc3, k, dtype)``: the [d, n_loc3, k] Gaussian
    start block of one LOBPCG run in the JAX package's node-major order
    (default ``ops.lobpcg.default_start``, a torch.Generator seeded 0).
    ``budget_bytes``: device bytes allowed to one domain chunk of the
    LOBPCG runs and of the float64 A z products of E."""
    opts.validate()
    require_full_f32()
    device = torch.device(device)
    start = lobpcg_start or default_start

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def mark(name, t0):
        sync()
        if timers is not None:
            timers.add(name, time.perf_counter() - t0)
        return time.perf_counter()

    sd = _geom(g, dom_grid, overlap)
    n_dom = sd.n_dom
    sx, sy, sz = sd.local_shape
    n_loc3 = sx * sy * sz * 3
    pad1 = tuple(p + 1 if gg > 1 else 0
                 for p, gg in zip(sd.pad, sd.dom_grid))
    gshape = tuple(g.shape)

    t = time.perf_counter()
    # cell-weight fields (node-embedded at the cell's lower corner), one
    # upload and one gather per window geometry
    ecn = g.cell_node_field()
    em = [sd.axis_edge_mult(a).astype(np.float64) for a in range(3)]
    cmult = em[2][:, None, None] * em[1][None, :, None] \
        * em[0][None, None, :]
    ecn_w = np.where(cmult > 0, ecn / np.maximum(cmult, 1.0), 0.0)
    bcd = g.bc_diag()
    nm = sd.node_mult().astype(np.float64)
    bcn = np.where(nm > 0, bcd / np.maximum(nm, 1.0), 0.0)
    raw = torch.tensor(np.stack([np.asarray(h, np.float64).ravel()
                                 for h in (ecn, ecn_w, bcd, bcn, nm)]),
                       dtype=dtype, device=device)
    d1 = _gather_stack(raw, gshape, sd.dom_grid, pad1)
    d2 = _gather_stack(raw, gshape, sd.dom_grid, sd.pad)
    del raw
    cw_dil = d1[0][:, :-1, :-1, :-1]
    bc_dir_dil = d1[2]
    maskd = d1[5]
    cw_inner = d2[0][:, :-1, :-1, :-1]
    cw_neu = d2[1][:, :-1, :-1, :-1]
    bc_dir, bc_neu, mult, maskf = d2[2], d2[3], d2[4], d2[5]
    k0d = torch.tensor(g.k0, dtype=dtype, device=device)
    gop = elastic_op(g, dtype, device)

    # window pads of the embed-and-dilate Dirichlet apply
    dil_pads = tuple(1 if gg > 1 else 0 for gg in sd.dom_grid[::-1])
    dir_dil = LocalElastic(cw=cw_dil, k0=k0d, diag_add=bc_dir_dil,
                           pads=(0, 0, 0))
    dir_wrap = LocalElastic(cw=cw_dil, k0=k0d, diag_add=bc_dir_dil,
                            pads=dil_pads)
    neu_op = LocalElastic(cw=cw_neu, k0=k0d, diag_add=bc_neu,
                          pads=(0, 0, 0))
    pou_b = torch.where(maskf > 0, 1.0 / torch.clamp(mult, min=1.0),
                        torch.zeros_like(mult))

    # level-1 solver: inexact surrogate-preconditioned PCG (no exact
    # route exists for 27-point block stencils — the MUMPS equivalent is
    # approximated; paired with flexible CG outside)
    rob_op = None
    if opts.lvl1_oras or opts.lvl2_num == 2:
        border = ((mult > 1.0) & (maskf > 0)).to(dtype)
        rob_op = RobinOp(dir_op=dir_wrap, neu_op=neu_op, border=border,
                         optim=torch.tensor(opts.optim, dtype=dtype,
                                            device=device))
    l1_op = rob_op if opts.lvl1_oras else dir_wrap
    pre_l1 = _scalar_surrogate(g.k0, cw_inner, bc_dir, maskf, 0.0)
    l1 = solvers.PCGSolver(st=l1_op, pre=pre_l1, maskf=maskf,
                           rtol=float(opts.dls1.rtol),
                           max_it=min(int(opts.dls1.max_it), 200),
                           reduce_dims=(-4, -3, -2, -1))
    t = mark("l1_minv", t)

    stats = GenEOStats(
        estim_dim_e=np.zeros(n_dom, np.int64),
        real_dim_e=np.zeros(n_dom, np.int64),
        nicolaides=np.zeros(n_dom, np.int64),
        tau_loc=np.full(n_dom, -1.0), gamma_loc=np.full(n_dom, -1.0))

    def make_pc(**kw):
        return ElasticGenEO(
            grid_shape=gshape, dom_grid=sd.dom_grid, pad=sd.pad,
            local_shape=sd.local_shape, lvl1=opts.lvl1, gop=gop, l1=l1,
            pou=pou_b, maskf=maskf,
            x0=torch.zeros(g.n_dof, dtype=dtype, device=device), **kw)

    if opts.lvl2_num == 0:
        return make_pc(lvl2=0, hybrid=False, eff_hybrid=False, dim_e=0,
                       k_max=0, z=None, colids=None, col_sel=None,
                       e_evecs=None, e_eig_inv=None), stats

    # ----- GenEO eigensolves -----
    # GenEO-1: (A_Neu, D A_Dir D) <= tau               (Def 7.14 of R1)
    # GenEO-2: (A_Neu, A_Rob) <= tauLoc ((19) of R4) and the swapped
    #          gamma pencil (A_Rob, D A_Dir D), mu <= 1/gammaLoc ((21) of
    #          R4) — the scalar backend's conventions
    #          (structured/geneo.py) on vector-component fields.
    b_dad = PouSandwich(op=dir_wrap, d=pou_b)
    max_it = min(int(opts.els2.max_it), 400) \
        if opts.els2.max_it < 10000 else 100
    eig_tol = float(opts.els2.rtol)
    box = (3, sz, sy, sx)
    maskc = maskf.unsqueeze(1).expand(n_dom, 3, sz, sy, sx) \
        .reshape(n_dom, 1, n_loc3)
    rigid0 = torch.tensor(rigid_modes(sd.local_shape), dtype=dtype,
                          device=device).reshape(6, n_loc3)

    def run_lobpcg(a_t, b_t, t_t, maskc_, k, seed_rigid, x0_prev):
        d = maskc_.shape[0]

        def a_op(v):
            return a_t.matvec(v.reshape((d, -1) + box)).reshape(d, -1,
                                                               n_loc3)

        def b_op(v):
            return b_t.matvec(v.reshape((d, -1) + box)).reshape(d, -1,
                                                               n_loc3)

        def t_op(v):
            w = t_t.solve(v.reshape((d, -1) + box))
            return w.reshape(d, -1, n_loc3) * maskc_

        # the start block in the node-major order -> [d, k, 3, box]
        x0 = torch.as_tensor(start(d, n_loc3, k, dtype)).to(device, dtype)
        x0 = x0.reshape(d, sz, sy, sx, 3, k).permute(0, 5, 4, 1, 2, 3) \
            .reshape(d, k, n_loc3)
        x0 = t_op(x0 * maskc_)
        if seed_rigid:
            # rigid modes are the exact near-kernel of the tau pencils'
            # A_Neu; the gamma pencil's extremal vectors are unrelated
            nr = min(6, k)
            x0[:, :nr] = rigid0[:nr] * maskc_
        if x0_prev is not None:
            x0[:, :x0_prev.shape[1]] = x0_prev
        return matfree_lobpcg(a_op, b_op, t_op, x0, max_it=max_it,
                              tol=eig_tol)

    def run_all(a_t, b_t, t_t, k, seed_rigid, x0_prev):
        # domain chunks within the byte budget (the Dirichlet sides apply
        # on the dilated window)
        per_dom = 3 * k * _block_bytes(sd.local_shape, True,
                                       maskf.element_size())
        chunk = int(np.clip(budget_bytes // max(per_dom, 1), 1, n_dom))
        parts = []
        for lo_i in range(0, n_dom, chunk):
            hi_i = min(lo_i + chunk, n_dom)
            sl = [_domains(tr, lo_i, hi_i)
                  for tr in (a_t, b_t, t_t, maskc, x0_prev)]
            parts.append(run_lobpcg(*sl[:4], k, seed_rigid, sl[4]))
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def dense_pencil(a_t, b_t, steer, flip):
        """Materialize the batched pencil from the cell-sum matvecs
        (identity probe — test scale only) and solve it with the exact
        host eigh: the scalar backend's dense route on vector fields.
        Pad slots are decoupled rows; ``steer`` pins their eigenvalues
        outside the kept window."""
        eye = torch.eye(n_loc3, dtype=dtype, device=device).expand(
            n_dom, n_loc3, n_loc3).reshape((n_dom, n_loc3) + box)
        a_d = a_t.matvec(eye).reshape(n_dom, n_loc3, n_loc3).transpose(1, 2)
        b_d = b_t.matvec(eye).reshape(n_dom, n_loc3, n_loc3).transpose(1, 2)
        padf = 1.0 - maskc[:, 0]
        pad_eye = padf[:, :, None] * padf[:, None, :] * torch.eye(
            n_loc3, dtype=dtype, device=device)
        a_eff = a_d - a_d * pad_eye + steer * pad_eye
        b_eff = b_d - b_d * pad_eye + pad_eye
        w_np, v_np = bl.generalized_eigh_host(a_eff.cpu().numpy(),
                                              b_eff.cpu().numpy())
        v = torch.tensor(v_np, dtype=dtype, device=device).transpose(1, 2)
        if flip:
            w_np = w_np[:, ::-1].copy()
            v = v.flip(1)
        return w_np, v

    dense_ok = opts.els2.type != "lobpcg" and n_loc3 <= 1024

    def run_pencil(label, a_t, b_t, t_t, thr, thr_dense, cut_p):
        """One GenEO pencil -> (w_np, v [d, k, n_loc3], base, kept_res)
        with w in the PENCIL-LAMBDA convention and the kept window a
        prefix (ascending tau / descending gamma); the gamma problem runs
        the SWAPPED pencil (smallest mu = 1/lambda)."""
        gamma_p = label == "gamma"
        if dense_ok:
            if gamma_p:
                # unswapped (D A_Dir D, A_Rob), largest lambda
                w_np, v = dense_pencil(b_t, a_t, 1e-6, flip=True)
                base = (w_np >= thr_dense[:, None]).sum(1).astype(np.int64)
            else:
                w_np, v = dense_pencil(a_t, b_t, 1e6, flip=False)
                base = (w_np <= thr_dense[:, None]).sum(1).astype(np.int64)
            if cut_p > 0:
                base = np.minimum(base, cut_p)
            return w_np, v, base, np.zeros(n_dom)
        # iterative route: warm-restarted candidate growth; elasticity
        # floats carry >= 6 rigid modes, so start at 8 (3 translations +
        # 3 rotations + margin)
        k_cand = min(cut_p if cut_p > 0 else 8, n_loc3)
        x_prev = None
        while True:
            w, v, res = run_all(a_t, b_t, t_t, k_cand, not gamma_p, x_prev)
            w_np = w.double().cpu().numpy()
            if cut_p > 0 or k_cand >= min(128, n_loc3):
                break
            if np.all(w_np[:, -1] > thr):
                break
            x_prev = v
            k_cand = min(k_cand * 2, min(128, n_loc3))
        res_np = res.double().cpu().numpy()
        base = (w_np <= thr[:, None]).sum(axis=1).astype(np.int64)
        if cut_p > 0:
            base = np.minimum(base, cut_p)
        kept_res = np.array([float(res_np[p, :base[p]].max())
                             if base[p] > 0 else 0.0 for p in range(n_dom)])
        if gamma_p:
            # map the swapped-pencil mu back to lambda = 1/mu
            w_np = 1.0 / np.maximum(w_np, np.finfo(np.float64).tiny)
        return w_np, v, base, kept_res

    # pencil list + shift-invert surrogate preconditioners
    cut_p = opts.cut
    if opts.lvl2_num == 2 and cut_p >= 2:
        cut_p = cut_p // 2                    # halved (geneo.cpp:1275)
    if opts.lvl2_num == 1:
        thr1 = np.full(n_dom, float(opts.tau))
        t1 = None if dense_ok else _scalar_surrogate(
            g.k0, cw_neu, bc_neu, maskf, float(opts.tau))
        pencils = [("tau", neu_op, b_dad, thr1, thr1, t1)]
    else:
        tl = tau_loc_structured(sd, opts.tau, opts.cst)
        gl = _gamma_loc(sd.adjacency(), n_dom, opts.gamma, opts.cst)
        stats.tau_loc, stats.gamma_loc = tl, gl
        thr2 = 1.0 / np.maximum(gl, 1e-12)    # swapped-pencil mu window
        if dense_ok:
            t1 = t2 = None
        else:
            # surrogates of (A_Neu + mean(tl) A_Rob) and (A_Rob +
            # mean(thr2) DADirD): Robin ~ Dirichlet cellwise (the optim
            # border term and the PoU sandwich are preconditioner-level
            # detail), so fold the Dirichlet weights in scaled
            tl_m = float(np.mean(tl))
            t1 = _scalar_surrogate(g.k0, cw_neu + tl_m * cw_inner,
                                   bc_neu + tl_m * bc_dir, maskf, 0.0)
            th_m = float(np.mean(thr2))
            t2 = _scalar_surrogate(g.k0, (1.0 + th_m) * cw_inner,
                                   (1.0 + th_m) * bc_dir, maskf, 0.0)
        pencils = [("tau", neu_op, rob_op, tl, tl, t1),
                   ("gamma", rob_op, b_dad, thr2, gl, t2)]

    runs = []
    for label, a_t, b_t, thr, thr_dense, t_t in pencils:
        tp = time.perf_counter()
        runs.append(run_pencil(label, a_t, b_t, t_t, thr, thr_dense, cut_p))
        sync()
        if timers is not None:
            dt = time.perf_counter() - tp
            timers.add("l2_eig", dt)
            timers.add(f"l2_{label}_eig", dt)
    t = time.perf_counter()

    w1_np, v1, base1, kept_res = runs[0]
    kept_res = kept_res.copy()
    if len(runs) > 1:
        lam2, v2, base2, kres2 = runs[1]
        kept_res = np.maximum(kept_res, kres2)
    else:
        v2, base2, lam2 = None, np.zeros(n_dom, np.int64), None
    stats.estim_dim_e = base1 + base2
    stats.lobpcg_res = kept_res

    # Nicolaides (geneo.cpp:897-955): constant vector over ALL components,
    # tested against the tau pencil's B operator
    b_tau = pencils[0][2]
    ones_b = maskc.reshape((n_dom,) + box)
    num_all = (ones_b * neu_op.matvec(ones_b)).sum((1, 2, 3, 4)) \
        .double().cpu().numpy()
    den_all = (ones_b * b_tau.matvec(ones_b)).sum((1, 2, 3, 4)) \
        .double().cpu().numpy()
    eps64 = np.finfo(np.float64).eps
    eps32 = np.finfo(np.float32).eps
    n_real = (maskf > 0).sum((1, 2, 3)).cpu().numpy()
    nic = np.zeros(n_dom, bool)
    for p in range(n_dom):
        if n_real[p] == 0:
            continue
        kept_min = w1_np[p, 0] if base1[p] > 0 else np.inf
        if base1[p] > 0 and kept_min < eps64:
            continue
        ratio = abs(num_all[p] / den_all[p]) if den_all[p] != 0 else np.inf
        if ratio <= eps32 or base1[p] + base2[p] == 0:
            nic[p] = True
    stats.nicolaides = nic.astype(np.int64)
    counts = base1 + nic + base2
    stats.real_dim_e = counts.copy()
    stats.raw_dim_e = counts.copy()
    stats.eigenvalues = [
        [float(x) for x in w1_np[p, :base1[p]]]
        + ([0.0] if nic[p] else [])
        + ([float(x) for x in lam2[p, :base2[p]]] if lam2 is not None
           else [])
        for p in range(n_dom)]
    k_max = max(int(counts.max()), 1)

    # D-weighted Z ((7.49) of R1): per domain the columns are [tau-kept
    # prefix, Nicolaides constant, gamma-kept prefix] — the generic
    # path's column order
    col = np.arange(k_max)

    def on_dev(a):
        return torch.as_tensor(a).to(device, dtype)[:, :, None]

    k1 = v1.shape[1]
    z = (v1[:, :k_max] if k1 >= k_max
         else F.pad(v1, (0, 0, 0, k_max - k1)))
    z = z * on_dev(col[None, :] < base1[:, None]) \
        + maskc * on_dev((col[None, :] == base1[:, None]) & nic[:, None])
    if v2 is not None:
        lo2 = (base1 + nic)[:, None]
        idx2 = np.clip(col[None, :] - lo2, 0, max(v2.shape[1] - 1, 0))
        m2 = (col[None, :] >= lo2) & (col[None, :] < counts[:, None])
        z2 = torch.gather(v2, 1, torch.from_numpy(idx2).to(device)[
            :, :, None].expand(n_dom, k_max, n_loc3))
        z = z + z2 * on_dev(m2)
    del v1, v2, runs
    z = z.reshape((n_dom, k_max) + box)
    z = z * (pou_b * maskf)[:, None, None]
    t = mark("l2_z", t)

    # E = Z^T A Z in float64 (near-null coarse columns cancel
    # eps(f32)*||A||-level terms; see structured/geneo.py): A z on the
    # dilated window, in domain chunks within the byte budget
    dir_e = dataclasses.replace(
        dir_dil, cw=cw_dil.double(), k0=k0d.double(),
        diag_add=bc_dir_dil.double())
    md_e = maskd.double()
    spatial = (dil_pads[2], dil_pads[2], dil_pads[1], dil_pads[1],
               dil_pads[0], dil_pads[0])
    per_dom = k_max * _cell_bytes((3,) + tuple(maskd.shape[1:]), 8)
    step = int(np.clip(budget_bytes // max(per_dom, 1), 1, n_dom))
    y_dil = torch.empty((n_dom, k_max, 3) + tuple(maskd.shape[1:]),
                        dtype=torch.float64, device=device)
    for lo_i in range(0, n_dom, step):
        hi_i = min(lo_i + step, n_dom)
        op_c = _domains(dir_e, lo_i, hi_i)
        y_dil[lo_i:hi_i] = op_c.matvec(F.pad(z[lo_i:hi_i].double(),
                                             spatial)) \
            * md_e[lo_i:hi_i, None, None]
    e = coarse_e(sd, z, y_dil, counts)
    del y_dil
    (z, colids, col_sel, e_evecs, e_eig_inv, dim_e, k_max,
     counts) = finalize_coarse(e, z, counts, stats, dtype)
    mark("l2_e", t)

    pc = make_pc(lvl2=opts.lvl2_num, hybrid=opts.hybrid,
                 eff_hybrid=opts.eff_hybrid, dim_e=dim_e, k_max=k_max, z=z,
                 colids=colids, col_sel=col_sel, e_evecs=e_evecs,
                 e_eig_inv=e_eig_inv)
    if opts.eff_hybrid and b is not None:
        pc = dataclasses.replace(pc, x0=pc.apply_q(b.to(device, dtype)))
    return pc, stats


# ===================== solve driver =====================

def make_elastic_inner(pc, inner_max_it: int = 2000, ip=None):
    """Inner correction solve ``inner(r32, rtol)`` in the preconditioner's
    dtype: flexible CG (the level-1 solves are inexact), stopping on
    stagnation (stall_its 50: the float32 floor is the f64 outer loop's
    business).  ``pc``: ElasticGenEO, or its ShardedGenEO with ``ip``
    the ranks' inner products."""
    eff = bool(pc.eff_hybrid)
    kw = {} if ip is None else {"ip": ip}

    def inner(r32, rtol):
        r = r32.to(pc.maskf.dtype)
        x0 = pc.apply_q(r) if eff else None
        return cg_solve(pc.matvec, r, pc.apply, x0=x0, rtol=rtol,
                        max_it=inner_max_it, stall_its=50, flexible=True,
                        **kw)

    return inner


def cast_tree(tree, dtype):
    """A setup product (dataclass tree) with its floating tensors in
    ``dtype``; integer tensors and plain values unchanged."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return tuple(cast_tree(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: cast_tree(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    return tree


def solve_elastic(g: ElasticGrid, dom_grid, overlap: int,
                  opts: GenEOOptions | None = None, tol: float = 1e-8,
                  dtype=None, timers=None, device="cuda",
                  device_refine: bool | None = None,
                  inner_max_it: int = 2000,
                  n_devices: int | None = None, lobpcg_start=None,
                  checkpoint_dir: str | None = None,
                  budget_bytes: float = BUDGET_BYTES,
                  setup_dtype=torch.float64):
    """End-to-end elasticity solve on ``device``: setup -> mixed-precision
    refined flexible CG to the true-f64 tolerance (the structured solve
    driver's twin, structured/solve.py).

    dtype (the inner Krylov vectors and the preconditioner) default:
    float32 on a card inside float64 refinement, float64 on the CPU —
    the elastic cell sum's float32 representation noise (~6e-8 relative)
    floors the refined residual near 4e-8 at small scale, and the CPU
    gains nothing from float32.  device_refine default: on for a card
    (float64 x/b/r and truth operator there), off for the CPU (the host
    route).

    ``setup_dtype`` (default float64): the precision of the setup
    (fields, eigensolves, Z; E is float64 always).  A float32 inner
    solve with a float64 setup casts the preconditioner to float32 and
    evaluates the global operator of the inner iterations in float64
    (the refinement's truth operator; each product is rounded to
    float32).  The JAX package's all-float32 setup and operator fail at
    high modulus contrast: a float32 cell sum cannot resolve the
    low-energy directions that the coarse space and the PC produce, p.Ap
    goes negative and CG stops on DIVERGED_INDEFINITE_MAT, and the
    float32 LOBPCG leaves a coarse space the prune cuts (PERF.md).
    ``lobpcg_start``, ``budget_bytes``: see setup_elastic;
    ``checkpoint_dir``: utils.checkpoint.setup_with_checkpoint.

    ``n_devices``: run on that many ranks, as solve_structured: flat [3n]
    vectors in z-slabs, contiguous domain chunks, the per-cell modulus
    and E replicated (structured/sharded.shard_elastic); in a group of
    that size this process is one rank, with none the ranks are launched
    here and rank 0's result comes back (without ``pc``)."""
    from ..krylov.refine import refined_solve, refined_solve_device
    from ..parallel import multiproc
    from ..utils.checkpoint import setup_with_checkpoint
    from ..utils.timers import Timers
    from .solve import StructuredSolveOutput

    ranks = None
    if n_devices is not None:
        from .sharded import need_divisible
        need_divisible(g.shape[2], int(np.prod(dom_grid)), n_devices)
        ranks = multiproc.group_ranks(n_devices, device)
        if ranks is None:
            return multiproc.run_ranks(_rank_solve, n_devices, args=(
                g, dom_grid, overlap, dict(
                    opts=opts, tol=tol, dtype=dtype, device=str(
                        torch.device(device).type),
                    device_refine=device_refine, inner_max_it=inner_max_it,
                    n_devices=n_devices, lobpcg_start=lobpcg_start,
                    budget_bytes=budget_bytes, setup_dtype=setup_dtype,
                    checkpoint_dir=checkpoint_dir)),
                device=device)
        device = ranks.device
    opts = opts or GenEOOptions()
    timers = timers or Timers()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(pass device='cpu' to run on the host)")
    require_full_f32()
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    if device_refine is None:
        device_refine = device.type == "cuda"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timers.add("partition", 0.0)
    t0 = time.perf_counter()
    op64 = elastic_op(g, torch.float64, device, budget_bytes) \
        if device_refine or setup_dtype != dtype else None
    if device_refine:
        x_true = torch.arange(1, g.n_dof + 1, dtype=torch.float64,
                              device=device)
        b = op64.matvec(x_true)
        del x_true
        sync()
    else:
        _xt, b = g.manufactured_rhs()
    timers.add("createA", time.perf_counter() - t0)

    t0 = time.perf_counter()
    pc, stats = setup_with_checkpoint(
        lambda: setup_elastic(g, dom_grid, overlap, opts,
                              b=torch.as_tensor(b).to(device, setup_dtype),
                              dtype=setup_dtype, timers=timers,
                              device=device, lobpcg_start=lobpcg_start,
                              budget_bytes=budget_bytes),
        g, dom_grid, overlap, opts, setup_dtype, timers, checkpoint_dir,
        device, ranks)
    if setup_dtype != dtype:
        pc = dataclasses.replace(cast_tree(pc, dtype), gop=op64)
    sync()
    timers.add("setup", time.perf_counter() - t0)

    if ranks is not None:
        return _solve_elastic_ranks(g, pc, stats, op64, b, opts, tol,
                                    timers, ranks, inner_max_it,
                                    time.perf_counter(), device_refine)

    t0 = time.perf_counter()
    eff = bool(opts.eff_hybrid)
    inner = make_elastic_inner(pc, int(inner_max_it))
    if device_refine:
        ref = refined_solve_device(op64, b, inner, tol=tol,
                                   x0=pc.x0.double() if eff else None)
        true_res = ref.true_res
    else:
        ref = refined_solve(
            b, lambda x: b - g.matvec(x), inner, tol=tol,
            x0=pc.x0.cpu().numpy().astype(np.float64) if eff else None,
            device=device)
        true_res = float(np.linalg.norm(b - g.matvec(ref.x))
                         / np.linalg.norm(b))
    sync()
    timers.add("solve", time.perf_counter() - t0)
    if device_refine:
        ref.x, b = ref.x.cpu().numpy(), b.cpu().numpy()
    return StructuredSolveOutput(
        refined=ref, x=ref.x, b=b, pc_name=opts.name, stats=stats,
        timers=timers, true_res=true_res, n_dof=g.n_dof,
        n_dom=int(np.prod(dom_grid)), pc=pc)


def _rank_solve(g, dom_grid, overlap, kw):
    """One launched rank of solve_elastic(n_devices=...)."""
    from .solve import host_output
    return host_output(solve_elastic(g, dom_grid, overlap, **kw))


def _solve_elastic_ranks(g, pc, stats, op64, b, opts, tol, timers, ranks,
                         inner_max_it, t_setup, device_refine):
    """The iterations of a multi-rank elastic solve on this rank's planes
    and domains, by the single-process refinement route
    (``device_refine``)."""
    from ..krylov import common as cm
    from ..krylov.refine import refined_solve, refined_solve_device
    from .sharded import shard_elastic, shard_refine64
    from .solve import StructuredSolveOutput

    device = ranks.device
    _mv, _ap, sh, shard_vec = shard_elastic(pc, ranks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timers.add("setup", time.perf_counter() - t_setup)
    t0 = time.perf_counter()
    ip = cm.DistInner(ranks.group)
    inner = make_elastic_inner(sh, int(inner_max_it), ip=ip)
    x0 = sh.x0.double() if opts.eff_hybrid else None
    if device_refine:
        ref = refined_solve_device(shard_refine64(op64, ranks),
                                   shard_vec(b), inner, tol=tol, x0=x0,
                                   ip=ip)
        ref.x = sh.unshard(ref.x)
        b = b.cpu().numpy()
        true_res = ref.true_res
    else:
        def inner_host(r32, rtol):
            res = inner(shard_vec(r32), rtol)
            return dataclasses.replace(res, x=torch.from_numpy(
                sh.unshard(res.x)))

        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        ref = refined_solve(
            b, lambda x: b - g.matvec(x), inner_host, tol=tol,
            x0=None if x0 is None else sh.unshard(x0), device=device)
        true_res = float(np.linalg.norm(b - g.matvec(ref.x))
                         / np.linalg.norm(b))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timers.add("solve", time.perf_counter() - t0)
    return StructuredSolveOutput(
        refined=ref, x=ref.x, b=b, pc_name=opts.name, stats=stats,
        timers=timers, true_res=true_res, n_dof=g.n_dof,
        n_dom=int(np.prod(pc.dom_grid)), pc=sh)
