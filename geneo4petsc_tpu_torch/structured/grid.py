"""Structured-grid problem definition: vectorized heterogeneous Laplacian.

Produces EXACTLY the same assembled operator as the element-path generator
(models/laplacian.py, itself a port of tst/laplacian/laplacian.cpp): 1-D
two-node FEM elements kappa * [[1+eps, -1], [-1, 1+eps]] along every grid
axis, the edge coefficient evaluated at the edge's LOWER endpoint (the
generator's raster-scan emission point), plus a 1-DOF Dirichlet ghost
kappa * (1+eps) on the lower boundary face of the LAST ACTIVE axis
(laplacian.cpp:118-189).  The host side is vectorized NumPy over the whole
grid — no element lists — so a 10M-node 3-D mesh builds in seconds.

Array convention: fields are [nz, ny, nx] with node id = x + nx*(y + ny*z)
(x fastest — the generator's d1 axis).  ``GlobalStencil`` is the operator
on the device, as torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import _grid


@dataclass
class StructuredGrid:
    """Host-side structured problem: grid shape + stencil fields.

    Default construction (the laplacian workload) derives the stencil from
    the per-node ``kappa`` field: 1-D two-node elements
    kappa * [[1+eps, -1], [-1, 1+eps]] per axis edge, ghost
    kappa * (1+eps) on the BC face.  Generalized workloads (heat's
    lbd*Laplacian + Mass/dt, non-separable coefficient fields) supply the
    three stencil fields explicitly via ``edge_off_``/``edge_diag_``/
    ``bc_val_`` — any symmetric operator assembled from per-axis 2-node
    edge elements with EQUAL endpoint diagonals plus nodal ghosts fits.
    """

    shape: tuple[int, int, int]       # (nx, ny, nz); inactive axes = 1
    kappa: np.ndarray                 # [nz, ny, nx] float64
    inp_eps: float = 0.0001
    dim: int = 3
    # general stencil fields (None -> derived from kappa, laplacian rules)
    edge_off_: tuple | None = None    # per axis: A[v, v+e_a] stored at v
    edge_diag_: tuple | None = None   # per axis: diag add at BOTH endpoints
    bc_val_: np.ndarray | None = None  # nodal ghost diag add
    _diag: np.ndarray | None = field(default=None, repr=False)
    # generator-set hint: True/False when the builder KNOWS whether kappa
    # is a separable kx*ky*kz product (laplacian_grid: True,
    # inclusion_grid: False); None -> fdm._axis_profiles verifies by full
    # reconstruction (O(N) host work)
    separable_hint: bool | None = field(default=None, repr=False)
    _edge_off_cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        # A True hint lets fdm._axis_profiles skip its O(N) reconstruction
        # check, so the field it vouches for must not change under it:
        # freeze the array so an in-place edit raises.
        if self.separable_hint is True:
            self.kappa.flags.writeable = False

    @property
    def n_nodes(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def is_kappa_stencil(self) -> bool:
        """True when the stencil is the pure kappa-derived Laplacian —
        the precondition for the separable FDM fast path (fdm.py)."""
        return self.edge_off_ is None

    # ---------------- stencil fields ----------------

    def edge_coeff(self, axis: int) -> np.ndarray:
        """Kappa coefficient of the edge (v, v + e_axis) stored at v
        (the laplacian-derivation helper); zero on the grid's upper face."""
        c = self.kappa.copy()
        ax = 2 - axis                  # array axis for x/y/z
        n = self.shape[axis]
        if n == 1:
            return np.zeros_like(c)
        sl = [slice(None)] * 3
        sl[ax] = slice(n - 1, n)
        c[tuple(sl)] = 0.0
        return c

    def edge_mask(self, axis: int) -> np.ndarray:
        """1.0 where the edge (v, v + e_axis) exists (upper face zero)."""
        m = np.ones(self.shape[::-1])
        n = self.shape[axis]
        ax = 2 - axis
        if n == 1:
            return np.zeros_like(m)
        sl = [slice(None)] * 3
        sl[ax] = slice(n - 1, n)
        m[tuple(sl)] = 0.0
        return m

    def edge_off(self, axis: int) -> np.ndarray:
        """Off-diagonal VALUE of the edge (v, v + e_axis) stored at v
        (memoized: setup and the f64 truth operator re-read it)."""
        if self.edge_off_ is not None:
            return self.edge_off_[axis]
        key = ("off", axis)
        if key not in self._edge_off_cache:
            self._edge_off_cache[key] = -self.edge_coeff(axis)
        return self._edge_off_cache[key]

    def edge_diag(self, axis: int) -> np.ndarray:
        """Diagonal contribution of the edge stored at v, added to BOTH
        endpoints (symmetric equal-diagonal edge elements)."""
        if self.edge_diag_ is not None:
            return self.edge_diag_[axis]
        key = ("diag", axis)
        if key not in self._edge_off_cache:
            self._edge_off_cache[key] = \
                (1.0 + self.inp_eps) * self.edge_coeff(axis)
        return self._edge_off_cache[key]

    def bc_val(self) -> np.ndarray:
        """Nodal Dirichlet-ghost diagonal contribution field."""
        if self.bc_val_ is not None:
            return self.bc_val_
        key = ("bc",)
        if key not in self._edge_off_cache:
            self._edge_off_cache[key] = \
                (1.0 + self.inp_eps) * self.kappa * self.bc_mask()
        return self._edge_off_cache[key]

    def bc_mask(self) -> np.ndarray:
        """Boolean [nz, ny, nx]: nodes carrying the Dirichlet ghost element
        (lower face of the last active axis)."""
        m = np.zeros(self.shape[::-1], dtype=bool)
        ax = 2 - (self.dim - 1)        # array axis of the last active axis
        sl = [slice(None)] * 3
        sl[ax] = slice(0, 1)
        m[tuple(sl)] = True
        return m

    def diag(self) -> np.ndarray:
        """Assembled global diagonal [nz, ny, nx] (float64)."""
        if self._diag is not None:
            return self._diag
        d = np.zeros(self.shape[::-1], dtype=np.float64)
        for axis in range(3):
            c = self.edge_diag(axis)
            ax = 2 - axis
            d += c                                       # edge up
            d += np.roll(c, 1, axis=ax) * _not_first(self.shape, axis)
        d += self.bc_val()
        self._diag = d
        return d

    # ---------------- host operator ----------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Assembled A @ x, vectorized host stencil apply (float64) — the
        f64 truth operator of the host refinement route."""
        xg = np.asarray(x, np.float64).reshape(self.shape[::-1])
        y = self.diag() * xg
        for axis in range(3):
            if self.shape[axis] == 1:
                continue
            c = self.edge_off(axis)
            ax = 2 - axis
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(None, -1)
            hi[ax] = slice(1, None)
            lo, hi = tuple(lo), tuple(hi)
            y[lo] += c[lo] * xg[hi]
            y[hi] += c[lo] * xg[lo]
        return y.ravel()

    def manufactured_rhs(self) -> tuple[np.ndarray, np.ndarray]:
        """(x_true, b) with x_true = (1, 2, 3, ...) — the reference's
        manufactured-solution oracle (createB, geneo4PETSc.cpp:815-834)."""
        x = np.arange(1.0, self.n_nodes + 1)
        return x, self.matvec(x)


def _slices(ndim: int, ax: int):
    """(lower, upper) index tuples selecting [:-1] and [1:] on ``ax``."""
    lo = [slice(None)] * ndim
    hi = [slice(None)] * ndim
    lo[ax] = slice(None, -1)
    hi[ax] = slice(1, None)
    return tuple(lo), tuple(hi)


def stencil_apply(diag: torch.Tensor, offs, x: torch.Tensor,
                  sp_axes: tuple) -> torch.Tensor:
    """y = diag*x plus, per axis a, y[v] += c[v] x[v+e] and
    y[v+e] += c[v] x[v] — the 7-point product of the structured path.

    ``sp_axes``: x's (z, y, x) axes; the fields have x's rank (size 1
    on any block axis).  Each term is one fused multiply-add over a
    shifted slice, added in the order of the JAX shifted-window form
    (per axis: the upper, then the lower neighbour), so the two agree to
    rounding."""
    y = diag * x
    for a, c in enumerate(offs):
        ax = sp_axes[2 - a]
        if x.shape[ax] == 1:
            continue
        lo, hi = _slices(x.ndim, ax)
        y[lo].addcmul_(c[lo], x[hi])
        y[hi].addcmul_(c[lo], x[lo])
    return y


@dataclass(frozen=True)
class GlobalStencil:
    """Device twin of StructuredGrid.matvec: the assembled global operator
    as diag + per-axis edge-coefficient fields — the iteration-phase
    product, with no index arrays.

    diag:  [nz, ny, nx];  coeff[a]: off-diagonal VALUE A[v, v+e_a] stored
    at v (upper face zero)."""

    diag: torch.Tensor
    coeff: tuple
    grid_shape: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: flat [n] -> A @ x, same shape."""
        nx, ny, nz = self.grid_shape
        y = stencil_apply(self.diag, self.coeff, x.reshape(nz, ny, nx),
                          (0, 1, 2))
        return y.reshape(x.shape)


def derive_stencil_fields(raw: torch.Tensor, grid_shape, bc_ax: int,
                          inp_eps: float, explicit: bool):
    """Global stencil fields from the raw upload, mirroring the host
    derivation (StructuredGrid.edge_off/edge_diag/bc_val/diag) op for op
    and in the same f64 addition order.

    raw: [1, nz, ny, nx] kappa (explicit=False, laplacian rules) or
         [7, nz, ny, nx] (eoff x3, ediag x3, bcv)."""
    if explicit:
        eoff = [raw[a] for a in range(3)]
        ediag = [raw[3 + a] for a in range(3)]
        bcv = raw[6]
    else:
        kappa = raw[0]
        eoff, ediag = [], []
        for a in range(3):
            n = grid_shape[a]
            ax = 2 - a
            if n == 1:
                z = torch.zeros_like(kappa)
                eoff.append(z)
                ediag.append(z)
                continue
            ec = kappa.clone()
            ec.narrow(ax, n - 1, 1).zero_()
            eoff.append(-ec)
            ediag.append((1.0 + inp_eps) * ec)
        bcv = torch.zeros_like(kappa)
        bcv.narrow(bc_ax, 0, 1).copy_(
            ((1.0 + inp_eps) * kappa).narrow(bc_ax, 0, 1))
    diag = torch.zeros_like(raw[0])
    for a in range(3):
        ax = 2 - a
        c = ediag[a]
        diag = diag + c
        rolled = torch.roll(c, 1, dims=ax)
        rolled.narrow(ax, 0, 1).zero_()              # _not_first mask
        diag = diag + rolled
    diag = diag + bcv
    return tuple(eoff), tuple(ediag), bcv, diag


def raw_fields(g: StructuredGrid, diag: bool) -> tuple[np.ndarray, bool]:
    """The f64 upload of a grid: its kappa field [1, nz, ny, nx], or for
    explicit-field grids the stacked edge offsets, then either the
    assembled diagonal (``diag``) or the edge diagonals and ghost field.
    Returns (raw, explicit)."""
    if g.edge_off_ is None:
        return np.asarray(g.kappa, np.float64)[None], False
    tail = ([g.diag()] if diag else
            [g.edge_diag(a) for a in range(3)] + [g.bc_val()])
    return np.stack([np.asarray(f, np.float64)
                     for f in [g.edge_off(a) for a in range(3)] + tail]), True


def global_stencil(g: StructuredGrid, dtype=torch.float32,
                   device="cuda") -> GlobalStencil:
    """Stage the assembled operator fields on ``device``.

    Kappa-derived grids upload ONE f64 kappa field and derive eoff/diag
    there (same f64 op order as the host builder); explicit-field grids
    upload eoff x3 + diag stacked."""
    raw_np, explicit = raw_fields(g, diag=True)
    raw = torch.tensor(raw_np, device=device)
    if explicit:
        eoff, diag = tuple(raw[a] for a in range(3)), raw[3]
    else:
        eoff, _ediag, _bcv, diag = derive_stencil_fields(
            raw, g.shape, 2 - (g.dim - 1), float(g.inp_eps), False)
    return GlobalStencil(diag=diag.to(dtype).contiguous(),
                         coeff=tuple(e.to(dtype).contiguous() for e in eoff),
                         grid_shape=tuple(g.shape))


def _not_first(shape, axis):
    """[nz, ny, nx] mask: 1 where coord along `axis` > 0."""
    n = shape[axis]
    ax = 2 - axis
    m = np.ones(n)
    m[0] = 0.0
    sh = [1, 1, 1]
    sh[ax] = n
    return m.reshape(sh)


def laplacian_grid(size: int, dim: int = 3, kappa_max: float = 1.0,
                   interp: str = "", inp_eps: float = 0.0001,
                   weak_scaling: int = 1) -> StructuredGrid:
    """Vectorized equivalent of models/laplacian.get_input for structured
    use: kappa(x,y,z) = kx(x)*ky(y)*kz(z) with the reference's per-axis
    profiles (quad/lin/minmax, laplacianServices.cpp:7-39)."""
    n = _grid.grid_size(size, weak_scaling, dim)
    alpha, beta = _grid.init_kappa(n, interp, kappa_max)

    def profile(m):
        if m == 1:
            # inactive axis: the generator evaluates kappa at coord 0
            return np.array([_grid.compute_kappa(interp, alpha, 0.0, beta)])
        xs = np.arange(m, dtype=np.float64)
        if interp == "quad":
            return alpha * xs * xs + beta
        if interp == "lin":
            return alpha * xs + beta
        if interp == "minmax":
            return np.where(xs >= 2.0 * beta, 1.0,
                            np.where(xs >= beta, alpha, 1.0))
        return np.ones(m)

    nx = n
    ny = n if dim >= 2 else 1
    nz = n if dim >= 3 else 1
    kx, ky, kz = profile(nx), profile(ny), profile(nz)
    kappa = kz[:, None, None] * ky[None, :, None] * kx[None, None, :]
    return StructuredGrid(shape=(nx, ny, nz), kappa=kappa,
                          inp_eps=inp_eps, dim=dim, separable_hint=True)


def heat_grid(size: int, dim: int = 3, kappa_max: float = 1.0,
              interp: str = "", inp_eps: float = 0.0001,
              lbd: float = 1.0, dt: float = 0.1,
              weak_scaling: int = 1) -> StructuredGrid:
    """Vectorized equivalent of models/heat.get_input (a port of
    tst/heat/heat.cpp): per-axis edge elements
    lbd * kappa * [[1+eps, -1], [-1, 1+eps]] + [[1/3, 1/6], [1/6, 1/3]]/dt
    with the 3-D kappa evaluated at the edge's lower endpoint, ghost
    lbd * kappa * (1+eps) + (1/3)/dt on the BC face.  The mass term's unit
    other-axis factors break kappa-separability, so heat runs through the
    general (non-FDM) structured solvers."""
    base = laplacian_grid(size, dim=dim, kappa_max=kappa_max, interp=interp,
                          inp_eps=inp_eps, weak_scaling=weak_scaling)
    edge_off, edge_diag = [], []
    for a in range(3):
        em = base.edge_mask(a)
        c = base.edge_coeff(a)
        edge_off.append(-lbd * c + em / (6.0 * dt))
        edge_diag.append(lbd * (1.0 + inp_eps) * c + em / (3.0 * dt))
    bc_val = (lbd * (1.0 + inp_eps) * base.kappa
              + 1.0 / (3.0 * dt)) * base.bc_mask()
    return StructuredGrid(shape=base.shape, kappa=base.kappa,
                          inp_eps=inp_eps, dim=dim,
                          edge_off_=tuple(edge_off),
                          edge_diag_=tuple(edge_diag), bc_val_=bc_val)


def inclusion_grid(size: int, dim: int = 3, kappa_max: float = 1e4,
                   n_inc: int = 27, inp_eps: float = 0.0001,
                   seed: int = 7) -> StructuredGrid:
    """High-contrast NON-SEPARABLE coefficient field: kappa = 1 background
    with ``n_inc`` spherical inclusions of kappa_max at deterministic
    pseudo-random centers.  Spheres are not axis-aligned products, so the
    separable FDM fast path cannot factor it; it exercises the general
    inexact local solvers at scale."""
    nx = size
    ny = size if dim >= 2 else 1
    nz = size if dim >= 3 else 1
    rng = np.random.default_rng(seed)
    kappa = np.ones((nz, ny, nx))
    zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    r = max(size // 10, 1)
    for _ in range(n_inc):
        cx = rng.integers(0, nx)
        cy = rng.integers(0, ny) if ny > 1 else 0
        cz = rng.integers(0, nz) if nz > 1 else 0
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
        kappa[d2 <= r * r] = kappa_max
    return StructuredGrid(shape=(nx, ny, nz), kappa=kappa,
                          inp_eps=inp_eps, dim=dim, separable_hint=False)
