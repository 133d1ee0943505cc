"""Fast-diagonalization (FDM) subdomain direct solver.

The reference factors every subdomain with MUMPS sparse LU
(directLocalSolve, src/geneo.cpp:94-124).  For SEPARABLE coefficient
fields — exactly what the reference's laplacian generator produces,
kappa(x,y,z) = kx(x)*ky(y)*kz(z) (tst/laplacian/laplacianServices.cpp:
7-39) — both local operators GenEO needs are Kronecker sums over per-axis
1-D tridiagonal operators:

  A_loc = T_z (x) D_y (x) D_x  +  D_z (x) T_y (x) D_x  +  D_z (x) D_y (x) T_x

  * Dirichlet block (assembled A restricted to the box,
    src/geneo.cpp:1697-1705): D_a = diag(k_a), T_a = 1-D operator with the
    GLOBAL assembled diagonal (edges leaving the box still contribute
    their diagonal part) and in-box couplings only; the boundary ghost
    element (laplacian.cpp:118-189) adds w*k(0) to the first diagonal
    entry of the last active axis.
  * Neumann block (the MatIS local matrix weighted by 1/elem_mult,
    geneo4PETSc.cpp:473-476): same shape with edge weights k_a/e_a and
    axis factors D_a = diag(k_a/m_a) — separable because the box edge and
    node multiplicities are per-axis interval-count products.

Symmetrizing with S = (x)_a D_a^{-1/2} turns the sum into commuting
terms; eigendecomposing the three small 1-D operators
P_a L_a P_a^T = D_a^{-1/2} T_a D_a^{-1/2} gives the EXACT inverse

  A^{-1} = ((x)_a D_a^{-1/2} P_a) (L_z ⊕ L_y ⊕ L_x + sigma)^{-1}
           ((x)_a D_a^{-1/2} P_a)^T

— six batched products per solve with O(L^2) factor memory per domain.
The optional sigma shifts by sigma * (x)_a D_a — for the Neumann axes
that is sigma * diag(kappa/mult), the SPD shift used as the LOBPCG
shift-invert preconditioner (the ARPACK STSINVERT analogue,
src/geneo.cpp:635-650).  The products run in the factor's dtype at full
precision: callers keep TF32 off (``ops.batched_linalg.require_full_f32``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .decompose import StructuredDecomposition


@dataclass(frozen=True)
class AxisOps:
    """Host-side per-axis 1-D operators, batched over domains.

    Axis order is (x, y, z); arrays are [n_dom, L_a] / [n_dom, L_a - 1].
    ``d`` is the diagonal Kronecker factor of the OTHER axes' terms;
    out-of-grid pad slots carry d = 1, t_diag = 1, zero couplings — inert
    positive decoupled rows (the FDM analogue of the generic path's
    identity-row padding convention).
    """

    t_diag: tuple   # per axis: [n_dom, L_a]
    t_off: tuple    # per axis: [n_dom, L_a - 1]
    d: tuple        # per axis: [n_dom, L_a]


def axis_profiles(sd: StructuredDecomposition):
    """Per-axis global kappa profiles (kx, ky, kz) recovered from the
    separable grid field; raises ValueError if the field is not
    separable.  Memoized on the decomposition (the reconstruction check
    is O(N) host work)."""
    cached = getattr(sd, "_axis_profiles_cache", None)
    if cached is None:
        try:
            cached = _axis_profiles_impl(sd)
        except ValueError as e:
            cached = e
        sd._axis_profiles_cache = cached
    if isinstance(cached, Exception):
        raise cached
    return cached


def _axis_profiles_impl(sd: StructuredDecomposition):
    g = sd.grid
    k = np.asarray(g.kappa, np.float64)
    kx = k[0, 0, :].copy()
    ky = k[0, :, 0].copy()
    kz = k[:, 0, 0].copy()
    ref = kx[0]
    if not (ref > 0.0):
        raise ValueError("FDM requires positive kappa")
    # normalize so kx*ky*kz == kappa with the ky[0] = kz[0] scale folded
    # into x
    ky = ky / ref
    kz = kz / ref
    hint = g.separable_hint
    if hint is False:
        raise ValueError("kappa field is not separable; use the "
                         "block-tridiagonal or generic path")
    if hint is not True:
        # full reconstruction check, one z slab at a time
        ky_kx = ky[:, None] * kx[None, :]
        for z in range(k.shape[0]):
            if not np.allclose(kz[z] * ky_kx, k[z], rtol=1e-12, atol=0.0):
                raise ValueError("kappa field is not separable; use the "
                                 "block-tridiagonal or generic path")
    return kx, ky, kz


def fdm_eligible(sd: StructuredDecomposition) -> bool:
    """True when the exact FDM fast path applies: kappa-derived Laplacian
    stencil with a separable coefficient field."""
    if not sd.grid.is_kappa_stencil:
        return False
    try:
        axis_profiles(sd)
        return True
    except ValueError:
        return False


def _windows(sd: StructuredDecomposition, a: int):
    """Global indices [g_a, L_a] of each domain position's local slots
    along axis a, and their in-grid mask."""
    n = sd.grid.shape[a]
    lo = np.arange(sd.dom_grid[a]) * sd.inner[a] - sd.pad[a]
    gidx = lo[:, None] + np.arange(sd.local_shape[a])[None, :]
    return gidx, (gidx >= 0) & (gidx < n)


def _by_domain(sd: StructuredDecomposition, a: int, per_pos: np.ndarray):
    """[g_a, L] per-position arrays -> [n_dom, L] by domain position."""
    return per_pos[sd.dom_positions()[a]]


def _bc_axis(sd: StructuredDecomposition) -> int:
    """Axis carrying the Dirichlet ghost elements: the LAST ACTIVE axis
    (laplacian.cpp boundary face; grid.bc_mask)."""
    return sd.grid.dim - 1


def dirichlet_axes(sd: StructuredDecomposition) -> AxisOps:
    """1-D axis operators of the batched Dirichlet blocks."""
    profs = axis_profiles(sd)
    w = 1.0 + sd.grid.inp_eps
    t_diag, t_off, dd = [], [], []
    for a in range(3):
        n = sd.grid.shape[a]
        ll = sd.local_shape[a]
        k = profs[a]
        # global 1-D assembled diagonal (edge up while not last + edge
        # down while not first) + BC ghost on the last active axis
        tg = np.zeros(n)
        if n > 1:
            tg[:-1] += w * k[:-1]
            tg[1:] += w * k[:-1]
        if a == _bc_axis(sd):
            tg[0] += w * k[0]
        gidx, ok = _windows(sd, a)
        gc = np.clip(gidx, 0, n - 1)
        td = np.where(ok, tg[gc], 1.0)
        da = np.where(ok, k[gc], 1.0)
        if ll > 1:
            eidx = gidx[:, :-1]
            eok = (eidx >= 0) & (eidx + 1 <= n - 1)
            to = np.where(eok, -k[np.clip(eidx, 0, n - 1)], 0.0)
        else:
            to = np.zeros((gidx.shape[0], 0))
        t_diag.append(_by_domain(sd, a, td))
        t_off.append(_by_domain(sd, a, to))
        dd.append(_by_domain(sd, a, da))
    return AxisOps(t_diag=tuple(t_diag), t_off=tuple(t_off), d=tuple(dd))


def neumann_axes(sd: StructuredDecomposition) -> AxisOps:
    """1-D axis operators of the batched weighted Neumann blocks
    (the MatIS local matrices: edge weights 1/elem_mult, BC ghost weight
    1/node_mult — both separable per-axis interval-count products)."""
    profs = axis_profiles(sd)
    w = 1.0 + sd.grid.inp_eps
    t_diag, t_off, dd = [], [], []
    for a in range(3):
        n = sd.grid.shape[a]
        ll = sd.local_shape[a]
        k = profs[a]
        em = sd.axis_edge_mult(a).astype(np.float64)     # [n], 0 on top
        nm = sd.axis_node_mult(a).astype(np.float64)     # [n]
        gidx, ok = _windows(sd, a)
        gc = np.clip(gidx, 0, n - 1)
        g = gidx.shape[0]
        # weighted member edges: both endpoints in the (dilated) box —
        # automatic for consecutive local slots — and inside the grid
        if ll > 1:
            eidx = gidx[:, :-1]
            eok = (eidx >= 0) & (eidx + 1 <= n - 1)
            ec = np.clip(eidx, 0, n - 1)
            ce = np.where(eok, k[ec] / np.maximum(em[ec], 1.0), 0.0)
            to = -ce
        else:
            ce = np.zeros((g, 0))
            to = np.zeros((g, 0))
        td = np.zeros((g, ll))
        if ll > 1:
            td[:, :-1] += w * ce
            td[:, 1:] += w * ce
        if a == _bc_axis(sd):
            # ghost weight 1/m_a(0) (the other axes' 1/m_b live in d)
            td += np.where(gidx == 0, w * k[0] / nm[0], 0.0)
        td = np.where(ok, td, 1.0)
        da = np.where(ok, k[gc] / nm[gc], 1.0)
        t_diag.append(_by_domain(sd, a, td))
        t_off.append(_by_domain(sd, a, to))
        dd.append(_by_domain(sd, a, da))
    return AxisOps(t_diag=tuple(t_diag), t_off=tuple(t_off), d=tuple(dd))


def _apply_axis(m: torch.Tensor, y: torch.Tensor, axis: int,
                transpose: bool) -> torch.Tensor:
    """Contract axis ``axis`` (0=x, 1=y, 2=z) of the block
    y [d, m, lz, ly, lx] with the per-domain matrix m [d, L, L]:
    out[.., w, ..] = sum_v M[v, w] y[.., v, ..] (``transpose``) or
    sum_w M[v, w] y[.., w, ..]."""
    d, k, lz, ly, lx = y.shape
    if axis == 0:                   # x is the fastest axis: one bmm
        mm = m if transpose else m.transpose(1, 2)
        out = torch.bmm(y.reshape(d, k * lz * ly, lx), mm)
        return out.reshape(d, k, lz, ly, lx)
    mm = (m.transpose(1, 2) if transpose else m).unsqueeze(1)
    if axis == 1:
        out = torch.matmul(mm, y.reshape(d, k * lz, ly, lx))
    else:
        out = torch.matmul(mm, y.reshape(d, k, lz, ly * lx))
    return out.reshape(d, k, lz, ly, lx)


@dataclass(frozen=True)
class FDMFactor:
    """Batched fast-diagonalization factor.

    p[a]:   [n_dom, L_a, L_a] combined transform D_a^{-1/2} P_a
            (columns = whitened eigenvectors), axis order (x, y, z)
    lam[a]: [n_dom, L_a] eigenvalues of D_a^{-1/2} T_a D_a^{-1/2}
    shift:  0-d tensor sigma — solves (A + sigma * (x)_a D_a) u = x
    den:    [n_dom, lz, ly, lx] lam_z + lam_y + lam_x + sigma
    """

    p: tuple
    lam: tuple
    shift: torch.Tensor
    den: torch.Tensor

    def solve(self, x: torch.Tensor) -> torch.Tensor:
        """x: [n_dom, lz, ly, lx] or a block [n_dom, m, lz, ly, lx]."""
        single = x.ndim == 4
        y = x.unsqueeze(1) if single else x
        # adjoint transform (x)_a (D^-1/2 P)^T, then the forward one
        for a in (2, 1, 0):
            y = _apply_axis(self.p[a], y, a, transpose=True)
        y = y / self.den.unsqueeze(1)
        for a in (2, 1, 0):
            y = _apply_axis(self.p[a], y, a, transpose=False)
        return y.squeeze(1) if single else y


def fdm_factor(ax: AxisOps, shift: float = 0.0, dtype=torch.float32,
               device="cuda") -> FDMFactor:
    """Eigendecompose the three whitened 1-D operators (in f64 on the
    host — they are tiny) and stage the batched transforms on
    ``device``."""
    ps, lams = [], []
    for a in range(3):
        td = np.asarray(ax.t_diag[a], np.float64)
        to = np.asarray(ax.t_off[a], np.float64)
        d = np.asarray(ax.d[a], np.float64)
        n_dom, ll = td.shape
        t = np.zeros((n_dom, ll, ll))
        idx = np.arange(ll)
        t[:, idx, idx] = td
        if ll > 1:
            i2 = np.arange(ll - 1)
            t[:, i2, i2 + 1] = to
            t[:, i2 + 1, i2] = to
        ds = 1.0 / np.sqrt(d)
        t = t * ds[:, :, None] * ds[:, None, :]
        lam, q = np.linalg.eigh(t)
        ps.append(torch.tensor(ds[:, :, None] * q, dtype=dtype,
                               device=device))
        lams.append(torch.tensor(lam, dtype=dtype, device=device))
    sigma = torch.tensor(shift, dtype=dtype, device=device)
    lx, ly, lz = lams
    den = (lz[:, :, None, None] + ly[:, None, :, None]
           + lx[:, None, None, :] + sigma)
    return FDMFactor(p=tuple(ps), lam=tuple(lams), shift=sigma,
                     den=den.contiguous())


def axes_matvec(ax: AxisOps, x: torch.Tensor) -> torch.Tensor:
    """Reference Kronecker-sum product (testing): applies
    sum_a (x D..) T_a (..D x) to x [n_dom, lz, ly, lx]."""
    dt, dev = x.dtype, x.device
    res = torch.zeros_like(x)
    ds = [torch.as_tensor(np.asarray(ax.d[a]), dtype=dt, device=dev)
          for a in range(3)]
    for a in range(3):
        td = np.asarray(ax.t_diag[a], np.float64)
        to = np.asarray(ax.t_off[a], np.float64)
        ll = td.shape[1]
        t = np.zeros((td.shape[0], ll, ll))
        idx = np.arange(ll)
        t[:, idx, idx] = td
        if ll > 1:
            i2 = np.arange(ll - 1)
            t[:, i2, i2 + 1] = to
            t[:, i2 + 1, i2] = to
        y = x
        for b in range(3):
            if b != a:
                shape = [ds[b].shape[0], 1, 1, 1]
                shape[3 - b] = ds[b].shape[1]
                y = y * ds[b].reshape(shape)
        tt = torch.as_tensor(t, dtype=dt, device=dev)
        res = res + _apply_axis(tt, y.unsqueeze(1), a,
                                transpose=False).squeeze(1)
    return res
