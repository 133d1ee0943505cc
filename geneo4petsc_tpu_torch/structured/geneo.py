"""Structured GenEO preconditioner — the 10M+ DOF scale path.

The same two-level Schwarz mathematics as precond/geneo.py (and
src/geneo.cpp), rebuilt on the structured backend:

  * local direct solves  -> fast diagonalization (fdm.py) instead of
    dense Cholesky blocks: O(L^2) factor memory, exact solves as batched
    products (the MUMPS replacement, src/geneo.cpp:94-124);
  * halo exchange        -> block-grid shifts (halo.py) instead of
    gather/scatter tables (VecScatter analogue, src/geneo.cpp:1845-1900);
  * GenEO eigensolves    -> matrix-free batched LOBPCG on the stencil
    pencils with the exact shifted FDM inverse as the shift-invert
    preconditioner (ARPACK STSINVERT, src/geneo.cpp:635-650);
  * E = Z^T A Z          -> per-offset window contractions: A z_d is
    computed with a one-layer-dilated Dirichlet stencil, and each
    neighbour block of E is one batched [n_dom, k, k] product over the
    static box-intersection windows (MatPtAP, src/geneo.cpp:1033).

The full preconditioner family runs here: lvl1 in {ASM, RAS, SRAS, ORAS,
SORAS}, lvl2 in {0, 1, H1, E1, 2, H2, E2}.  Separable kappa-derived
Laplacian stencils take the exact FDM route; everything else (heat's mass
term, non-separable coefficient fields, border-restricted Robin blocks)
takes the general solvers (solvers.py).  Setup is host-orchestrated;
``apply`` is the per-iteration hot path, every tensor on one device.
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
from ..ops import batched_linalg as bl
from ..ops.batched_linalg import require_full_f32
from ..ops.lobpcg import default_start, matfree_lobpcg
from ..precond.geneo import (GenEOStats, _gamma_loc, factor_e,
                             prune_dependent_columns,
                             warn_coarse_replication)
from . import fdm, halo, solvers
from . import local_ops as lo
from .block_tridiag import bt_inertia
from .decompose import StructuredDecomposition
from .grid import GlobalStencil, global_stencil

# device memory budget of one LOBPCG domain chunk (~16 block panels)
LOBPCG_BUDGET_BYTES = 6e9


class LocalSchwarz:
    """The per-iteration mathematics of the structured preconditioners
    (applyGenEOPC, src/geneo.cpp:2051-2098) written on local boxes, so
    that every vector layout shares it: the global layout
    (StructuredGenEO, ElasticGenEO), the block-major one
    (blockmode.BlockGenEO) and the rank-split one
    (sharded.ShardedGenEO).  A layout supplies ``_gather`` (vector ->
    local boxes [n_dom, (3,) lz, ly, lx]), ``_scatter`` (the adjoint)
    and ``matvec``; the fields below come from the set-up
    preconditioner.  Fields [n_dom, lz, ly, lx] meet vector boxes
    through ``lo.lift`` (a unit component axis for the elastic
    backend)."""

    def coarse_local(self, xb: torch.Tensor, coarse_w=None) -> torch.Tensor:
        """Z E^-1 Z^T on local boxes, before the scatter (applyQ).
        ``coarse_w(ztx)``: the global coarse vector from the flat local
        Z^T x (default: the real entries in order; the rank-split layout
        adds the ranks' entries)."""
        n_dom = xb.shape[0]
        zf = self.z.reshape(n_dom, self.k_max, -1)
        ztx = torch.bmm(zf, xb.reshape(n_dom, -1, 1)).reshape(-1)
        # the real coarse columns are numbered in domain order, so the
        # global coarse vector is the real entries of Z^T x in order
        w = ztx[self.col_sel] if coarse_w is None else coarse_w(ztx)
        w = self.e_evecs @ (self.e_eig_inv * (self.e_evecs.T @ w))
        wl = torch.cat([w, w.new_zeros(1)])[self.colids]     # [d, k_max]
        return torch.bmm(wl.unsqueeze(1), zf).reshape(xb.shape)

    def l1_local(self, xb: torch.Tensor) -> torch.Tensor:
        """The level-1 solve on local boxes, masked (applyLevel1)."""
        if self.lvl1 in ("RAS", "SRAS", "ORAS", "SORAS"):
            xb = xb * lo.lift(self.pou, xb)         # (1.29) of R1
        ub = self.l1.solve(xb)
        if self.lvl1 in ("SRAS", "SORAS"):
            ub = ub * lo.lift(self.pou, ub)
        # pad slots are decoupled in the factor but masking pins them to
        # exact zeros
        return ub * lo.lift(self.maskf, ub)

    # ---------------- level 2: Q = Z E^-1 Z^T (applyQ) ----------------
    def apply_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.coarse_local(self._gather(x)))

    # ---------------- level 1 (applyLevel1) ----------------
    def _local_solve(self, x: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.l1_local(self._gather(x)))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Full PC apply (applyGenEOPC): Y = Q X + L1(X) with optional
        hybrid projections — (7.53) of R1."""
        if self.lvl2 and not self.eff_hybrid:
            y = self.apply_q(x)
        else:
            y = torch.zeros_like(x)
        t = x
        if self.hybrid and not self.eff_hybrid:
            t = t - self.matvec(y)                  # (I - P^T) x
        t = self._local_solve(t)
        if self.hybrid:
            t = t - self.apply_q(self.matvec(t))    # (I - P) t
        return y + t

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


@dataclass(frozen=True)
class StructuredGenEO(LocalSchwarz):
    """Immutable setup product; ``apply`` is the per-iteration hot path.

    Mirrors GenEOPreconditioner.apply semantics exactly (applyGenEOPC,
    src/geneo.cpp:2051-2098) so iteration counts match the generic path.
    Block-vector fields are [n_dom, lz, ly, lx]; the coarse basis is
    [n_dom, k_max, lz, ly, lx]."""

    # --- static configuration ---
    grid_shape: tuple
    dom_grid: tuple
    pad: tuple
    local_shape: tuple
    lvl1: str          # ASM | RAS | SRAS | ORAS | SORAS
    lvl2: int          # 0 | 1 | 2
    hybrid: bool
    eff_hybrid: bool
    dim_e: int
    k_max: int
    # --- data ---
    gop: GlobalStencil           # assembled global operator
    l1: object                   # FDMFactor | BTSolver | PCGSolver (.solve)
    pou: torch.Tensor | None     # partition of unity
    maskf: torch.Tensor          # float real-slot mask
    z: torch.Tensor | None       # D-weighted coarse basis
    colids: torch.Tensor | None  # [d, k_max] int64 (pad -> dim_e)
    col_sel: torch.Tensor | None  # flat positions of the real colids
    e_evecs: torch.Tensor | None  # [K, K] coarse factor W (E^-1 = W D W^T)
    e_eig_inv: torch.Tensor | None  # [K]
    x0: torch.Tensor             # [n] initial guess (Q b if eff-hybrid)
    # level-1 solves are exact (FDM / block-tridiag) vs inexact PCG —
    # inexact Schwarz callers pair with flexible CG
    l1_exact: bool = True

    # ---------------- halo plumbing ----------------
    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return halo.to_batch(halo.halo_gather(
            x, self.grid_shape, self.dom_grid, self.pad))

    def _scatter(self, xb: torch.Tensor) -> torch.Tensor:
        return halo.halo_scatter_add(
            halo.from_batch(xb, self.dom_grid), self.grid_shape,
            self.dom_grid, self.pad)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.gop.matvec(x)


# ===================== setup =====================

def _tree_map(fn, *objs):
    """Map ``fn`` over the tensors of tensors/tuples/dataclasses (0-d
    tensors and non-tensor fields pass through)."""
    o = objs[0]
    if isinstance(o, torch.Tensor):
        return fn(*objs) if o.ndim else o
    if isinstance(o, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*objs))
    if dataclasses.is_dataclass(o):
        return dataclasses.replace(o, **{
            f.name: _tree_map(fn, *(getattr(x, f.name) for x in objs))
            for f in dataclasses.fields(o)})
    return o


def _block_ops(a_st, b_st, maskf, t_tree):
    """LOBPCG operator callables on [d, m, n_loc] blocks."""
    n_dom, sz, sy, sx = maskf.shape
    box = (n_dom, -1, sz, sy, sx)
    flat = (n_dom, -1, sz * sy * sx)
    mk = maskf.unsqueeze(1)

    def a_op(v):
        return a_st.matvec(v.reshape(box)).reshape(flat)

    def b_op(v):
        return b_st.matvec(v.reshape(box)).reshape(flat)

    def t_op(v):
        return (t_tree.solve(v.reshape(box)) * mk).reshape(flat)

    return a_op, b_op, t_op


def finalize_coarse(e: np.ndarray, z: torch.Tensor, counts: np.ndarray,
                    stats: GenEOStats, dtype):
    """Prune linearly dependent coarse columns (pivoted Cholesky — see
    precond.geneo.prune_dependent_columns) and factor E (assembled in
    float64).  ``z`` is the [n_dom, k_max, ...] device basis.

    Returns (z, colids, col_sel, e_evecs, e_eig_inv, dim_e, k_max,
    counts)."""
    n_dom = counts.shape[0]
    dim_e = int(counts.sum())
    offs = np.zeros(n_dom, np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    keep = prune_dependent_columns(e, np.float64)
    if keep is not None:
        # E becomes SPD, dim_e shrinks by exactly the dependency count
        stats.e_pruned = dim_e - keep.size
        kept_mask = np.zeros(dim_e, bool)
        kept_mask[keep] = True
        new_counts = np.array(
            [int(kept_mask[offs[p]:offs[p] + counts[p]].sum())
             for p in range(n_dom)], np.int64)
        new_k_max = max(int(new_counts.max()), 1)
        idx = np.zeros((n_dom, new_k_max), np.int64)
        sel = np.zeros((n_dom, new_k_max), bool)
        for p in range(n_dom):
            js = np.flatnonzero(kept_mask[offs[p]:offs[p] + counts[p]])
            idx[p, :js.size] = js
            sel[p, :js.size] = True
            stats.eigenvalues[p] = [stats.eigenvalues[p][j] for j in js]
        gidx = torch.from_numpy(idx).to(z.device).reshape(
            (n_dom, new_k_max) + (1,) * (z.ndim - 2))
        z = torch.gather(z, 1, gidx.expand((n_dom, new_k_max)
                                           + z.shape[2:]))
        z = z * torch.from_numpy(sel).to(z.device, z.dtype).reshape(
            gidx.shape)
        e = e[np.ix_(keep, keep)]
        stats.real_dim_e = new_counts.copy()
        counts = new_counts
        offs = np.zeros(n_dom, np.int64)
        np.cumsum(counts[:-1], out=offs[1:])
        dim_e, k_max = int(counts.sum()), new_k_max
    else:
        k_max = max(int(counts.max()), 1)
    colids_np = np.full((n_dom, k_max), dim_e, np.int64)
    for p in range(n_dom):
        colids_np[p, :counts[p]] = offs[p] + np.arange(counts[p])
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    warn_coarse_replication(dim_e)
    ev_np, ew_np, stats.e_null = factor_e(e, np_dtype, e_dtype=np.float64)
    dev = z.device
    return (z, torch.from_numpy(colids_np).to(dev),
            torch.from_numpy(np.flatnonzero(colids_np.ravel() < dim_e)
                             ).to(dev),
            torch.tensor(ev_np, dtype=dtype, device=dev),
            torch.tensor(1.0 / ew_np, dtype=dtype, device=dev),
            dim_e, k_max, counts)


def tau_loc_structured(sd: StructuredDecomposition, tau: float,
                       cst: bool) -> np.ndarray:
    """Local adaptive tau (getLocalGenEOTau, src/geneo.cpp:1097-1118):
    tauLoc = k * tau with k = max DOF multiplicity, clamped to 0.9."""
    if cst:
        return np.full(sd.n_dom, tau)
    k = sd.max_mult().astype(np.float64)
    t = k * tau
    t = np.where(t >= 1.0, 0.9, t)
    return np.where(k > 0, t, tau)


def coarse_windows(sd: StructuredDecomposition):
    """[((ox, oy, oz), windows)] of every neighbour offset whose dilated
    box meets a domain's box; windows = per axis (z-basis slice,
    y-slice) in local coordinates (x, y, z order)."""
    divided = [g > 1 for g in sd.dom_grid]
    # boxes (p) and (p+o) overlap the dilated window while
    # |o| * inner < inner + 2 pad + 1
    radius = [int(np.ceil((2 * sd.pad[a] + 1) / sd.inner[a]))
              if divided[a] else 0 for a in range(3)]

    def windows(a, o):
        ll = sd.local_shape[a]
        if not divided[a]:
            return slice(0, ll), slice(0, ll)
        i = sd.inner[a]
        pp = sd.pad[a]
        if o == 0:
            return slice(0, ll), slice(1, ll + 1)
        length = i - abs(o) * i + 2 * pp + 1
        if o > 0:
            return slice(0, length), slice(o * i + 1, o * i + 1 + length)
        s = -o * i - 1
        return slice(s, s + length), slice(0, length)

    out = []
    for ox, oy, oz in product(*[range(-radius[a], radius[a] + 1)
                                for a in (0, 1, 2)]):
        ws = (windows(0, ox), windows(1, oy), windows(2, oz))
        if any(w.stop - w.start <= 0 for pair in ws for w in pair):
            continue
        out.append(((ox, oy, oz), ws))
    return out


def coarse_e(sd: StructuredDecomposition, z: torch.Tensor,
             y_dil: torch.Tensor, counts: np.ndarray) -> np.ndarray:
    """E = Z^T A Z via per-offset window contractions.

    z:     [n_dom, k_max, (c,) lz, ly, lx] D-weighted local basis (zero
           pad; the optional component axis c of the elastic backend)
    y_dil: [n_dom, k_max, (c,) dz, dy, dx] = A z_d on the
           one-layer-dilated box, in the precision E is assembled in
    Returns the REAL (unpadded) dense symmetric E [dim_e, dim_e] (host).

    A neighbour offset is a constant shift o_lin of the flat domain index
    (d = px + gx*(py + gy*pz)), so each offset contracts one aligned
    slice pair of whole domains; rows whose shift wraps an axis are
    discarded below."""
    gx, gy, gz = sd.dom_grid
    k_max = z.shape[1]
    n_dom = sd.n_dom
    offs_used = coarse_windows(sd)
    blocks = np.zeros((len(offs_used), n_dom, k_max, k_max))
    for io, ((ox, oy, oz), ws) in enumerate(offs_used):
        ((zwx, ywx), (zwy, ywy), (zwz, ywz)) = ws
        o_lin = ox + gx * oy + gx * gy * oz
        lo_v, hi_v = max(0, -o_lin), n_dom - max(0, o_lin)
        if hi_v <= lo_v:
            continue
        size = hi_v - lo_v
        zwin = z[lo_v + o_lin:hi_v + o_lin, :, ..., zwz, zwy, zwx]
        ywin = y_dil[lo_v:hi_v, :, ..., ywz, ywy, ywx]
        b = torch.bmm(zwin.to(y_dil.dtype).reshape(size, k_max, -1),
                      ywin.reshape(size, k_max, -1).transpose(1, 2))
        blocks[io, lo_v:hi_v] = b.double().cpu().numpy()

    dom_lin = np.arange(n_dom)
    px, py, pz = sd.dom_positions()
    rows_i, cols_i, vals = [], [], []
    for io, ((ox, oy, oz), _ws) in enumerate(offs_used):
        # validity: the source domain d + o must exist (no wraparound)
        ok = ((px + ox >= 0) & (px + ox < gx) & (py + oy >= 0)
              & (py + oy < gy) & (pz + oz >= 0) & (pz + oz < gz))
        f_lin = dom_lin + ox + gx * oy + gx * gy * oz   # row block (d + o)
        for d in np.where(ok)[0]:
            kf, kd = int(counts[f_lin[d]]), int(counts[d])
            if kf == 0 or kd == 0:
                continue
            b = blocks[io, d, :kf, :kd]
            rows_i.append(f_lin[d] * k_max + np.repeat(np.arange(kf), kd))
            cols_i.append(d * k_max + np.tile(np.arange(kd), kf))
            vals.append(b.ravel())
    import scipy.sparse as sp
    dim_e = int(counts.sum())
    if dim_e == 0:
        return np.zeros((0, 0))
    e_pad = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows_i), np.concatenate(cols_i))),
        shape=(n_dom * k_max, n_dom * k_max)).tocsr()
    sel = np.concatenate([p * k_max + np.arange(counts[p])
                          for p in range(n_dom)]).astype(np.int64)
    e = np.asarray(e_pad[np.ix_(sel, sel)].todense())
    return 0.5 * (e + e.T)


def setup_structured(sd: StructuredDecomposition, opts: GenEOOptions,
                     b: torch.Tensor | None = None, dtype=torch.float32,
                     timers=None, device="cuda", lobpcg_start=None,
                     bt_budget_bytes: float | None = None
                     ) -> tuple[StructuredGenEO, GenEOStats]:
    """Structured setUpGenEOPC: fields gather -> FDM factors -> batched
    matrix-free eigensolve -> Z -> E, on ``device`` except the tiny 1-D
    eigendecompositions and the coarse factorization (host float64).

    ``lobpcg_start(d, n_loc, k, dtype)`` gives the [d, n_loc, k] Gaussian
    start block of one LOBPCG run (default: ``default_start``); the same
    draw starts every domain chunk, as in the JAX package.
    ``bt_budget_bytes``: the factor memory allowed to the exact
    block-tridiagonal route of every general solve (the level-1 solver
    and the shift-invert preconditioners; default
    solvers.BT_BUDGET_BYTES): 0 sends them all to the inexact PCG route."""
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

    n_dom = sd.n_dom
    sx, sy, sz = sd.local_shape
    n_loc = sx * sy * sz
    pad1 = tuple(p + 1 if g > 1 else 0
                 for p, g in zip(sd.pad, sd.dom_grid))

    t = time.perf_counter()
    f_dil = lo.gather_fields(sd, dtype=dtype, pad=pad1, device=device)
    f = lo.slice_inner(f_dil, sd)
    maskf = f.mask.to(dtype)
    gop = global_stencil(sd.grid, dtype, device)
    sep = fdm.fdm_eligible(sd)

    # level-1 direct solver: exact FDM for separable Dirichlet blocks;
    # otherwise (Robin/ORAS, heat, non-separable kappa) the general
    # solvers — exact block-tridiag while the factor fits, inexact
    # surrogate-preconditioned PCG beyond (solvers.py policy)
    l1_exact = True
    l1_kw = dict(rtol=float(opts.dls1.rtol),
                 max_it=min(int(opts.dls1.max_it), 200),
                 bt_budget_bytes=bt_budget_bytes)
    if opts.lvl1_oras:
        l1, l1_exact = solvers.select_local_solver(
            lo.robin_stencil(f, opts.optim), maskf, sd.local_shape, **l1_kw)
    elif sep:
        l1 = fdm.fdm_factor(fdm.dirichlet_axes(sd), dtype=dtype,
                            device=device)
    else:
        l1, l1_exact = solvers.select_local_solver(
            lo.dirichlet_stencil(f), maskf, sd.local_shape, **l1_kw)
    t = mark("l1_minv", t)

    need_pou = opts.lvl2_num > 0 or opts.lvl1_ras
    pou_b = (torch.where(f.mask, 1.0 / torch.clamp(f.mult, min=1.0),
                         torch.zeros_like(f.mult)).to(dtype)
             if need_pou else None)

    stats = GenEOStats(
        estim_dim_e=np.zeros(n_dom, np.int64),
        real_dim_e=np.zeros(n_dom, np.int64),
        nicolaides=np.zeros(n_dom, np.int64),
        tau_loc=np.full(n_dom, -1.0), gamma_loc=np.full(n_dom, -1.0))

    def make_pc(**kw):
        return StructuredGenEO(
            grid_shape=sd.grid.shape, dom_grid=sd.dom_grid, pad=sd.pad,
            local_shape=sd.local_shape, lvl1=opts.lvl1, gop=gop, l1=l1,
            pou=pou_b, maskf=maskf,
            x0=torch.zeros(sd.grid.n_nodes, dtype=dtype, device=device),
            l1_exact=l1_exact, **kw)

    if opts.lvl2_num == 0:
        return make_pc(lvl2=0, hybrid=False, eff_hybrid=False, dim_e=0,
                       k_max=0, z=None, colids=None, col_sel=None,
                       e_evecs=None, e_eig_inv=None), stats

    # ----- GenEO eigensolves -----
    # GenEO-1: (A_Neu, D A_Dir D) <= tau               (Def 7.14 of R1)
    # GenEO-2: (A_Neu, A_Rob) <= tauLoc  ((19) of R4) and the REVERSED
    #          gamma pencil (A_Rob, D A_Dir D) with mu <= 1/gammaLoc
    #          ((21) of R4 — LOBPCG computes smallest, so the pencil is
    #          swapped and kept lambda = 1/mu >= gammaLoc)
    neu = lo.neumann_stencil(f)
    dirs = lo.dirichlet_stencil(f)
    b_dad = solvers.diag_congruence(dirs, pou_b)      # D A_Dir D

    max_it = min(int(opts.els2.max_it), 400) \
        if opts.els2.max_it < 10000 else 100
    eig_tol = float(opts.els2.rtol)

    def run_lobpcg(a_st, b_st, maskf_, t_tree, k, x0_prev=None):
        a_o, b_o, t_o = _block_ops(a_st, b_st, maskf_, t_tree)
        d = maskf_.shape[0]
        x0 = torch.as_tensor(start(d, n_loc, k, dtype))
        x0 = x0.to(device, dtype).transpose(1, 2) * maskf_.reshape(d, 1, -1)
        x0 = t_o(x0)
        if x0_prev is not None:
            # warm restart: keep the previously converged block, top up
            # with fresh preconditioned-random columns only
            x0[:, :x0_prev.shape[1]] = x0_prev
        return matfree_lobpcg(a_o, b_o, t_o, x0, max_it=max_it, tol=eig_tol,
                              k_monitor=k)

    def run_all(a_st, b_st, t_tree, k, x0_prev=None):
        # chunk the domain batch to a device-memory budget (LOBPCG live
        # set ~ 16 k-column panels); the last chunk is padded with the
        # first domains so every chunk has the same shape
        per_dom = n_loc * 16 * k * 4
        chunk = int(np.clip(LOBPCG_BUDGET_BYTES // max(per_dom, 1), 1,
                            n_dom))
        # BTSolver factors batch domains on dim 1 (plane-major)
        if chunk >= n_dom or isinstance(t_tree, solvers.BTSolver):
            return run_lobpcg(a_st, b_st, maskf, t_tree, k, x0_prev)
        trees = (a_st, b_st, maskf, t_tree, x0_prev)
        parts = []
        for lo_i in range(0, n_dom, chunk):
            hi_i = min(lo_i + chunk, n_dom)
            args = [_tree_map(lambda a: a[lo_i:hi_i], tr) for tr in trees]
            if hi_i - lo_i < chunk:
                pad_n = chunk - (hi_i - lo_i)
                args = [_tree_map(lambda a, c: torch.cat([a, c[:pad_n]]),
                                  a, tr) for a, tr in zip(args, trees)]
            out = run_lobpcg(*args[:4], k, x0_prev=args[4])
            parts.append(tuple(o[:hi_i - lo_i] for o in out))
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def dense_pencil(a_st, b_st, steer, flip):
        """Materialize the batched pencil densely from the stencil
        products (identity-block probe, test scale only) and solve it
        with the exact host eigh — the structured twin of the generic
        path's default els2 route.  ``steer``: the pad-diagonal
        eigenvalue (1e6 sorts pads above an ascending tau window, 1e-6
        below a descending gamma read); ``flip``: return the spectrum
        descending so the kept window of the gamma problem is again a
        prefix."""
        eye = torch.eye(n_loc, dtype=dtype, device=device).expand(
            n_dom, n_loc, n_loc).reshape(n_dom, n_loc, sz, sy, sx)
        a_d = a_st.matvec(eye).reshape(n_dom, n_loc, n_loc).transpose(1, 2)
        b_d = b_st.matvec(eye).reshape(n_dom, n_loc, n_loc).transpose(1, 2)
        padf = 1.0 - maskf.reshape(n_dom, n_loc)
        pad_eye = padf[:, :, None] * padf[:, None, :] * torch.eye(
            n_loc, dtype=dtype, device=device)
        a_eff = a_d - a_d * pad_eye + steer * pad_eye
        b_eff = b_d - b_d * pad_eye + pad_eye
        w_np, v_np = bl.generalized_eigh_host(a_eff.cpu().numpy(),
                                              b_eff.cpu().numpy())
        v = torch.tensor(v_np, dtype=dtype, device=device).transpose(1, 2)
        if flip:
            w_np = w_np[:, ::-1].copy()
            v = v.flip(1)
        return w_np, v

    # dense eigh is exact but O(n_loc^3): the default els2 route at test
    # scale; LOBPCG is the at-scale route (and the only one above this)
    dense_ok = opts.els2.type != "lobpcg" and n_loc <= 1024

    def run_pencil(label, a_st, b_st, t_tree, thr, thr_dense, cut_p):
        """One GenEO pencil.  Returns (w_np, v [d, k, n], base, kept_res)
        with w in the PENCIL-LAMBDA convention and the kept window always
        a prefix (ascending for tau, descending for gamma).

        Iterative route: candidate growth until every domain's window is
        strictly inside the computed prefix (the Sylvester-estimate role,
        estimateNumberOfEigenValues geneo.cpp:502-560, realized by
        inertia counts and warm-restarted doubling); the gamma problem
        runs the SWAPPED pencil (smallest mu = 1/lambda)."""
        gamma_p = label == "gamma"
        if dense_ok:
            if gamma_p:
                # unswapped (D A_Dir D, A_Rob), largest lambda
                w_np, v = dense_pencil(b_st, a_st, 1e-6, flip=True)
                base = (w_np >= thr_dense[:, None]).sum(1).astype(np.int64)
            else:
                w_np, v = dense_pencil(a_st, b_st, 1e6, flip=False)
                base = (w_np <= thr_dense[:, None]).sum(1).astype(np.int64)
            if cut_p > 0:
                base = np.minimum(base, cut_p)
            return w_np, v, base, np.zeros(n_dom)
        if cut_p > 0:
            k_cand = cut_p
        else:
            # Sylvester inertia of (A - theta B) through the block-tridiag
            # LDL^T plane recursion sizes the candidate block up front;
            # the warm-restarted doubling below remains the safety net
            s2_est = n_loc // max(max(sd.local_shape), 1)
            if not opts.no_syl and s2_est <= 192 and solvers.bt_bytes(
                    n_dom, sd.local_shape) <= 2e9:
                beta = torch.tensor(-thr, dtype=dtype,
                                    device=device).reshape(-1, 1, 1, 1)
                pen = solvers.add_scaled(a_st, b_st, beta)
                syl = bt_inertia(*lo.plane_coefficients(
                    pen, lo.plane_axis(sd.local_shape))).cpu().numpy()
                k_cand = int(np.clip(syl.max(), 1, min(128, n_loc)))
            else:
                k_cand = 8
        k_cand = min(k_cand, n_loc)
        x_prev = None
        while True:
            w, v, res = run_all(a_st, b_st, t_tree, k_cand, x_prev)
            w_np = w.double().cpu().numpy()
            if cut_p > 0 or k_cand >= min(128, n_loc):
                break
            if np.all(w_np[:, -1] > thr):
                break
            x_prev = v
            k_cand = min(k_cand * 2, min(128, n_loc))
        res_np = res.double().cpu().numpy()
        # the selection window is a PREFIX of the ascending candidates
        base = (w_np <= thr[:, None]).sum(axis=1).astype(np.int64)
        if cut_p > 0:
            base = np.minimum(base, cut_p)
        # keep only CONVERGED pairs — the reference uses exactly the
        # EPSGetConverged prefix (geneo.cpp:713-714): an unconverged
        # "eigenvector" is a junk direction that E^-1 then amplifies.
        # The window is a prefix, so truncate at the first unconverged
        # column.
        prune = 30.0 * eig_tol
        for p in range(n_dom):
            j = 0
            while j < base[p] and res_np[p, j] <= prune:
                j += 1
            base[p] = j
        kept_res = np.array([float(res_np[p, :base[p]].max())
                             if base[p] > 0 else 0.0 for p in range(n_dom)])
        if gamma_p:
            # map the swapped-pencil mu back to lambda = 1/mu
            w_np = 1.0 / np.maximum(w_np, np.finfo(np.float64).tiny)
        return w_np, v, base, kept_res

    # the pencil list + shift-invert preconditioners
    cut_p = opts.cut
    if opts.lvl2_num == 2 and cut_p >= 2:
        cut_p = cut_p // 2                    # halved (geneo.cpp:1275)
    t_kw = dict(rtol=5e-2, max_it=30,         # t_op is a preconditioner
                bt_budget_bytes=bt_budget_bytes)
    if opts.lvl2_num == 1:
        thr1 = np.full(n_dom, float(opts.tau))
        if dense_ok:
            t1 = None
        elif sep:
            # exact shifted Neumann FDM (the ARPACK STSINVERT analogue)
            t1 = fdm.fdm_factor(fdm.neumann_axes(sd), shift=float(opts.tau),
                                dtype=dtype, device=device)
        else:
            t1, _ = solvers.select_local_solver(
                solvers.add_scaled(neu, b_dad, float(opts.tau)), maskf,
                sd.local_shape, **t_kw)
        pencils = [("tau", neu, b_dad, thr1, thr1, t1)]
    else:
        rob = lo.robin_stencil(f, opts.optim)
        tl = tau_loc_structured(sd, opts.tau, opts.cst)
        gl = _gamma_loc(sd.adjacency(), n_dom, opts.gamma, opts.cst)
        stats.tau_loc, stats.gamma_loc = tl, gl
        thr2 = 1.0 / np.maximum(gl, 1e-12)    # swapped-pencil mu window
        if dense_ok:
            t1 = t2 = None
        else:
            t1, _ = solvers.select_local_solver(
                solvers.add_scaled(neu, rob, float(np.mean(tl))), maskf,
                sd.local_shape, **t_kw)
            t2, _ = solvers.select_local_solver(
                solvers.add_scaled(rob, b_dad, float(np.mean(thr2))),
                maskf, sd.local_shape, **t_kw)
        pencils = [("tau", neu, rob, tl, tl, t1),
                   ("gamma", rob, b_dad, thr2, gl, t2)]

    runs = []
    for label, a_st, b_st, thr, thr_dense, t_tree in pencils:
        tp = time.perf_counter()
        runs.append(run_pencil(label, a_st, b_st, t_tree, thr, thr_dense,
                               cut_p))
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

    # Nicolaides near-kernel test (geneo.cpp:897-955) on the tau pencil:
    # quadratic forms of the constant vector through the stencil operators
    b_tau = pencils[0][2]
    num_all = (maskf * neu.matvec(maskf)).sum((1, 2, 3)).double().cpu()
    den_all = (maskf * b_tau.matvec(maskf)).sum((1, 2, 3)).double().cpu()
    num_all, den_all = num_all.numpy(), den_all.numpy()
    n_real = (maskf > 0).sum((1, 2, 3)).cpu().numpy()
    eps64 = np.finfo(np.float64).eps
    eps32 = np.finfo(np.float32).eps

    nic = np.zeros(n_dom, bool)
    for p in range(n_dom):
        if n_real[p] == 0:
            continue
        kept_min = w1_np[p, 0] if base1[p] > 0 else np.inf
        if base1[p] > 0 and kept_min < eps64:
            continue  # a zero eigenvalue is already in the basis
        ratio = abs(num_all[p] / den_all[p]) if den_all[p] != 0 else np.inf
        if ratio <= eps32 or base1[p] + base2[p] == 0:
            # near-kernel constant OR forbidden-empty-set fallback
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

    # D-weighted coarse basis Z ((7.49) of R1), built on the device: per
    # domain the columns are [tau-kept prefix, Nicolaides constant,
    # gamma-kept prefix] — the generic path's column order
    col = np.arange(k_max)

    def on_dev(a):
        return torch.as_tensor(a).to(device, dtype)[:, :, None]

    k1 = v1.shape[1]
    z = (v1[:, :k_max] if k1 >= k_max
         else F.pad(v1, (0, 0, 0, k_max - k1)))
    z = z * on_dev(col[None, :] < base1[:, None]) \
        + maskf.reshape(n_dom, 1, n_loc) * on_dev(
            (col[None, :] == base1[:, None]) & nic[:, None])
    if v2 is not None:
        lo2 = (base1 + nic)[:, None]
        idx2 = np.clip(col[None, :] - lo2, 0, max(v2.shape[1] - 1, 0))
        m2 = (col[None, :] >= lo2) & (col[None, :] < counts[:, None])
        z2 = torch.gather(v2, 1, torch.from_numpy(idx2).to(device)[
            :, :, None].expand(n_dom, k_max, n_loc))
        z = z + z2 * on_dev(m2)
    z = z.reshape(n_dom, k_max, sz, sy, sx)
    z = z * pou_b.unsqueeze(1) * maskf.unsqueeze(1)
    t = mark("l2_z", t)

    # E = Z^T A Z: dilated-stencil apply + window contractions, in
    # float64: Z's columns are near-null vectors of A, so the contraction
    # cancels eps(f32)*||A||-level terms and an f32-assembled E is noise
    # at its own scale — the rank detection would then prune
    # load-bearing GenEO modes (52/64 at 32^3 in the JAX package).
    f_e = f_dil.map(lambda v: v.double() if v.is_floating_point() else v)
    dirs_dil = lo.dirichlet_stencil(f_e)
    spatial = [(1, 1) if p else (0, 0)
               for p in (sd.pad[0], sd.pad[1], sd.pad[2])]
    z_dil = F.pad(z.double(), [w for pair in spatial for w in pair])
    y_dil = dirs_dil.matvec(z_dil) * f_dil.mask.unsqueeze(1).double()
    e = coarse_e(sd, z, y_dil, counts)
    del y_dil, z_dil
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
