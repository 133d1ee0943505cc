"""The GenEO preconditioner on PyTorch tensors — two-level Schwarz.

The preconditioner family of src/geneo.cpp as a frozen dataclass of
tensors + plain functions:

  level 1: ASM / RAS / SRAS / ORAS / SORAS    (applyLevel1, geneo.cpp:1962-2038)
  level 2: 0 / GenEO-1 / GenEO-2, additive / hybrid (H) / efficient-hybrid (E)
           (setUpLevel2 geneo.cpp:1544-1608, applyQ :1435-1542,
            projectOnFineSpace :1902-1960, applyGenEOPC :2051-2098)

Mapping onto one device:
  * one subdomain per MPI rank  ->  subdomain batch axis
  * MUMPS per-domain LU         ->  batched Cholesky/LU, or precomputed
    block inverses applied by the fused kernel K1 (ops/local_kernels.py)
  * SLEPc/ARPACK shift-invert   ->  batched dense generalized eigh on the
    host (float64 LAPACK)
  * VecScatter halo exchange    ->  gather / table scatter-add
  * rank-0 offload of Z and E   ->  replication (the tiny coarse
    factorization lives next to the batch; -geneo_offload is a no-op)

Setup is host-orchestrated: the eigensolves, the coarse basis and
E = Z^T A Z run in NumPy/SciPy; the level-1 factorization runs on the
batch's device, and the finished products stay there.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..assembly.assemble import SubdomainBatch, robin_blocks
from ..config import GenEOOptions
from ..ops import batched_linalg as bl
from ..ops.local_kernels import fused_local_solve


@dataclass
class GenEOStats:
    """Per-domain setup statistics (reported via INFO lines,
    src/geneo4PETSc.cpp:968-988)."""

    estim_dim_e: np.ndarray   # [n_dom] Sylvester estimates
    real_dim_e: np.ndarray    # [n_dom] actual coarse columns (post-prune)
    nicolaides: np.ndarray    # [n_dom] constant vectors added
    tau_loc: np.ndarray       # [n_dom] local tau (GenEO-2)
    gamma_loc: np.ndarray     # [n_dom] local gamma (GenEO-2)
    eigenvalues: list = field(default_factory=list)  # per-domain kept spectra
    # (near-)null modes of E truncated by the spectral pseudo-inverse —
    # the MUMPS ICNTL(24)/CNTL(5) null-pivot analogue
    e_null: int = 0
    # linearly dependent coarse columns removed by the pivoted-Cholesky
    # pruning pass before factorizing E
    e_pruned: int = 0
    # [n_dom] columns selected by the eigenproblem windows + Nicolaides,
    # before the pruning pass (structured setup; None elsewhere)
    raw_dim_e: np.ndarray | None = None
    # [n_dom] LOBPCG relative residual, max over the kept pairs
    # (structured setup; None for the dense-eigh route)
    lobpcg_res: np.ndarray | None = None


@dataclass(frozen=True)
class GenEOPreconditioner:
    """Immutable setup product; ``apply`` is the hot per-iteration path.
    Every tensor lives on ``batch.device``."""

    # --- static configuration ---
    lvl1: str          # ASM | RAS | SRAS | ORAS | SORAS
    lvl2: int          # 0 | 1 | 2
    hybrid: bool
    eff_hybrid: bool
    dim_e: int         # total coarse-space dimension (0 if lvl2 == 0)
    k_max: int         # max per-domain coarse columns (padded)
    # "chol": l1_factor holds Cholesky factors (batched triangular solves).
    # "lu": l1_factor holds (LU, pivots).
    # "inv": l1_factor holds precomputed block inverses applied by K1.
    l1_kind: str
    # --- data ---
    batch: SubdomainBatch
    l1_factor: torch.Tensor | tuple  # [d, n, n] (or (LU, pivots))
    pou: torch.Tensor | None      # [d, n] partition of unity (None if unused)
    z_loc: torch.Tensor | None    # [d, n, k_max] D-weighted eigenvectors
    colids: torch.Tensor | None   # [d, k_max] int64 coarse column (pad=dim_e)
    e_evecs: torch.Tensor | None    # [K, K] E^-1 = W diag(e_eig_inv) W^T
    e_eig_inv: torch.Tensor | None  # [K] truncated inverse eigenvalues of E
    x0: torch.Tensor              # [n_dof] initial guess (Q b if eff-hybrid)

    # ---------------- level 2: Q = Z E^-1 Z^T (applyQ) ----------------
    def apply_q(self, x: torch.Tensor) -> torch.Tensor:
        xl = self.batch.gather(x)                       # [d, n]
        ztx = torch.einsum("dnk,dn->dk", self.z_loc, xl)
        # coarse columns are unique, so each real slot receives exactly
        # one value (the sum is exact); pads land in the dump slot dim_e
        w = x.new_zeros(self.dim_e + 1).index_add_(
            0, self.colids.reshape(-1), ztx.reshape(-1))[:-1]
        # E^-1 as W diag(e_eig_inv) W^T: W = L^-T with unit weights on the
        # Cholesky path, the eigenvectors with truncated inverse
        # eigenvalues on the spectral path (factor_e)
        w = self.e_evecs @ (self.e_eig_inv * (self.e_evecs.T @ w))
        wl = torch.cat([w, w.new_zeros(1)])[self.colids]  # [d, k_max]
        yl = torch.einsum("dnk,dk->dn", self.z_loc, wl)
        return self.batch.scatter_add(yl)

    # ---------------- level 1 (applyLevel1) ----------------
    def _local_solve(self, x: torch.Tensor) -> torch.Tensor:
        xl = self.batch.gather(x)
        ras = self.lvl1 in ("RAS", "SRAS", "ORAS", "SORAS")
        sras = self.lvl1 in ("SRAS", "SORAS")
        if self.l1_kind == "inv":
            xl = fused_local_solve(self.l1_factor, self.pou, self.batch.mask,
                                   xl, pre=ras, post=sras)
            return self.batch.scatter_add(xl)
        if ras:
            xl = xl * self.pou                          # (1.29) of R1
        if self.l1_kind == "lu":
            xl = bl.lu_solve(self.l1_factor, xl)
        else:
            xl = bl.cholesky_solve(self.l1_factor, xl)
        if sras:
            xl = xl * self.pou
        return self.batch.scatter_add(xl)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Full PC apply (applyGenEOPC): Y = Q X + L1(X) with optional
        hybrid projections — (7.53) of R1."""
        if self.lvl2 and not self.eff_hybrid:
            y = self.apply_q(x)                         # 1st term of (7.53)
        else:
            y = torch.zeros_like(x)
        t = x
        if self.hybrid and not self.eff_hybrid:
            t = t - self.batch.matvec(y)                # (I - P^T) x, reusing QX
        t = self._local_solve(t)
        if self.hybrid:
            t = t - self.apply_q(self.batch.matvec(t))  # (I - P) t
        return y + t

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


# ===================== setup (setUpGenEOPC equivalent) =====================

def _with_pad_diag(a: np.ndarray, mask: np.ndarray, value: float
                   ) -> np.ndarray:
    """Copy of ``a`` with the identity pad diagonal replaced by ``value``
    (steers the pencil eigenvalues of pad slots out of the selection
    window)."""
    out = a.copy()
    dom, idx = np.nonzero(~mask)
    out[dom, idx, idx] = (out[dom, idx, idx] - 1.0) + value
    return out


def _device_inverse(m_blocks: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse on the blocks' device: Cholesky (with the
    jitter fallback) + cholesky_inverse, row-major as K1 reads it."""
    return torch.cholesky_inverse(bl.cholesky_factor(m_blocks)).contiguous()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tau_loc(mult: np.ndarray, mask: np.ndarray, tau: float, cst: bool
             ) -> np.ndarray:
    """Local adaptive tau (getLocalGenEOTau, geneo.cpp:1097-1118):
    tauLoc = k * tau with k = max DOF multiplicity, clamped to 0.9."""
    n_dom = mult.shape[0]
    if cst:
        return np.full(n_dom, tau)
    k = np.where(mask, mult, 0).max(axis=1)
    t = k * tau
    t = np.where(t >= 1.0, 0.9, t)
    return np.where(k > 0, t, tau)


def _gamma_loc(adj: np.ndarray, n_dom: int, gamma: float, cst: bool
               ) -> np.ndarray:
    """Local adaptive gamma (getLocalGenEOGamma, geneo.cpp:1120-1232).

    NOTE (behavioral parity): the reference builds the connectivity matrix
    with C[p][q] = 1 when domains p and q do NOT intersect (and 0 when they
    do) — the test at geneo.cpp:1139-1145 is inverted relative to its own
    comment.  We reproduce the code's behavior, not the comment.
    C has unit diagonal; F_p = 1/rowsum(C); M = C * F F^T;
    gammaLoc_p = gamma / lambda_max(M) * F_p^2, clamped to 1.1 from below.

    ``adj``: boolean domain-intersection adjacency (Decomposition.adjacency).
    C = J - adj is DENSE (most domain pairs do not intersect), so for large
    batches lambda_max is computed matrix-free on M = f f^T - adj o f f^T
    (rank-1 minus sparse) with Lanczos — O(nnz(adj)) per matvec instead of
    an O(n_dom^3) dense eigensolve.
    """
    if cst:
        return np.full(n_dom, gamma)
    adj = np.asarray(adj, dtype=bool)
    f = 1.0 / (n_dom - adj.sum(axis=1)).astype(np.float64)
    if n_dom <= 1024:
        m = np.where(adj, 0.0, 1.0) * f[:, None] * f[None, :]
        lam = np.max(np.abs(np.linalg.eigvalsh(m)))
    else:
        import scipy.sparse as _sp
        import scipy.sparse.linalg as _spla
        rr, cc = np.nonzero(adj)
        b = _sp.csr_matrix((np.ones(len(rr)), (rr, cc)),
                           shape=(n_dom, n_dom))

        def mv(v):
            fv = f * v.ravel()
            return f * fv.sum() - f * (b @ fv)

        op = _spla.LinearOperator((n_dom, n_dom), matvec=mv,
                                  dtype=np.float64)
        v0 = np.full(n_dom, 1.0 / np.sqrt(n_dom))  # deterministic start
        lam = float(abs(_spla.eigsh(op, k=1, which="LM", v0=v0,
                                    return_eigenvectors=False)[0]))
    g = gamma / lam * f * f
    return np.where(g <= 1.0, 1.1, g)


def _select_columns(w: np.ndarray, kind: str, thr: np.ndarray,
                    n_real: np.ndarray, no_syl: bool, cut: int):
    """Per-domain eigenpair selection (eigenLocalProblem semantics).

    w: [d, n] pencil spectrum ascending, pad eigenvalues already steered out
    of the window.  Returns (keep_idx list per domain, estim per domain).

    ARPACK computes nev pairs nearest the target (the nev smallest for the
    shift-invert tau problem, the nev largest for the gamma problem) with
    nev = Sylvester estimate (estimateNumberOfEigenValues) unless -geneo_no_syl
    (then the EPS default nev = 1), capped by -geneo_cut; kept pairs are then
    filtered to [0, tau] / [gamma, inf) (geneo.cpp:713-714).
    """
    n_dom, n = w.shape
    keep, estim = [], np.zeros(n_dom, dtype=np.int64)
    for p in range(n_dom):
        if kind == "tau":
            count = int(np.sum(w[p, :n_real[p]] < thr[p]))
        else:
            real = w[p]  # gamma: pads steered to tiny values at the bottom
            count = int(np.sum(real[n - n_real[p]:] > thr[p])) \
                if n_real[p] else 0
        count = min(count, int(n_real[p]))
        if cut > 0:
            count = min(count, cut)
        estim[p] = count
        nev = count if not no_syl else min(1, int(n_real[p]))
        if no_syl and cut > 0:
            nev = min(nev, cut)
        if kind == "tau":
            cand = np.arange(nev)
            sel = cand[w[p, cand] <= thr[p]] if nev else cand
        else:
            cand = np.arange(n - 1, n - 1 - nev, -1)
            sel = cand[w[p, cand] >= thr[p]] if nev else cand
        keep.append(sel.astype(np.int64))
    return keep, estim


def prune_dependent_columns(e: np.ndarray, dtype) -> np.ndarray | None:
    """Detect linearly dependent coarse columns via pivoted Cholesky.

    E = Z^T A Z with A SPD, so null modes of E correspond exactly to
    dependent columns of Z.  LAPACK dpstrf stops at the numerical rank;
    the dropped pivots identify which columns to prune (the principled
    replacement for MUMPS null-pivot *fixing*, geneo.cpp:76-92: pruning
    shrinks the coarse space and keeps the PC nonsingular).

    Returns the SORTED indices of the independent columns, or None when E
    is already numerically full rank (the common case — zero cost beyond
    one dpstrf)."""
    from scipy.linalg.lapack import dpstrf

    dim_e = e.shape[0]
    if dim_e == 0:
        return None
    dmax = float(np.diagonal(e).max(initial=0.0))
    tol = dim_e * np.finfo(dtype).eps * dmax
    _c, piv, rank, _info = dpstrf(e, lower=1, tol=tol)
    rank = int(rank)
    if rank >= dim_e:
        return None
    return np.sort(piv[:rank] - 1).astype(np.int64)


def factor_e(e: np.ndarray, dtype, e_dtype=None
             ) -> tuple[np.ndarray, np.ndarray, int]:
    """Factor the coarse operator E (host LAPACK, float64).

    Returns (W, ew, e_null) with E^-1 applied as W diag(1/ew) W^T.
    Fast path: E is SPD when the selected columns are independent, so a
    Cholesky factor L with W := L^{-T} gives E^{-1} = W diag(1) W^T —
    the spectral-apply layout of apply_q at a fraction of eigh's cost.
    The spectral pseudo-inverse stays as the fallback for (near-)singular
    E — the MUMPS null-pivot-fix analogue (geneo.cpp ICNTL(24)/CNTL(5));
    e_null counts the truncated modes.  ``dtype`` (the precision the
    factors are applied in) gates the Cholesky path; ``e_dtype`` (the
    precision E was assembled in, default ``dtype``) sets the truncation
    floor of the spectral fallback."""
    if e_dtype is None:
        e_dtype = dtype
    dim_e = e.shape[0]
    if dim_e > 0:
        try:
            c = np.linalg.cholesky(e)
            dg = np.diagonal(c)
            # numerically near-singular E must take the truncating
            # spectral fallback even when dpotrf happens to succeed
            if dg.min() ** 2 > dim_e * np.finfo(dtype).eps * dg.max() ** 2:
                from scipy.linalg.lapack import dtrtri
                linv, info = dtrtri(c, lower=1)
                if info == 0:
                    return np.ascontiguousarray(linv.T), np.ones(dim_e), 0
        except np.linalg.LinAlgError:
            pass
    ew, ev = bl.host_eigh(e)
    tol = dim_e * np.finfo(e_dtype).eps * np.abs(ew).max(initial=0.0)
    e_null = int((ew <= tol).sum())
    ew = np.where(ew > tol, ew, np.inf)  # truncated modes
    return ev, ew, e_null


def setup_geneo(batch: SubdomainBatch, opts: GenEOOptions,
                b: torch.Tensor | None = None, decomp=None, timers=None,
                a_csr=None) -> tuple[GenEOPreconditioner, GenEOStats]:
    """Full preconditioner setup (PCSetUp -> setUpGenEOPC path).

    The level-1 factorization runs on the batch's device; the level-2
    eigensolves, the coarse basis Z and E = Z^T A Z run on the host in
    float64 (the reference's cost model: ARPACK/MUMPS/LAPACK setup on
    CPU, src/geneo.cpp:626-780).  For the efficient-hybrid variants
    (E1/E2) and a given ``b``, the initial guess is x0 = Q b
    (setUpLevel2, geneo.cpp:1601-1604).

    ``timers``: optional utils.timers.Timers — records the reference's
    per-phase setup taxonomy (l1_minv, l2_{tau,gamma}_{syl,eig},
    l2_{syl,eig,z,e}; geneo.hpp:113-123)."""
    pc, stats = _setup_geneo_impl(batch, opts, decomp, timers, a_csr)
    if opts.eff_hybrid and b is not None:
        pc = dataclasses.replace(pc, x0=pc.apply_q(b))
    return pc, stats


def _assembled_csr_from_batch(batch: SubdomainBatch, n_real):
    """Host assembled operator from the unassembled blocks (MatIS -> AIJ
    conversion, the setUpGenEOPC MatConvert at geneo.cpp:1692)."""
    import scipy.sparse as sp
    gids = batch.gids.cpu().numpy()
    a = batch.a_neu.cpu().numpy().astype(np.float64, copy=False)
    rows, cols, vals = [], [], []
    for p in range(batch.n_dom):
        k = int(n_real[p])
        if not k:
            continue
        g = gids[p, :k]
        rows.append(np.repeat(g, k))
        cols.append(np.tile(g, k))
        vals.append(a[p, :k, :k].ravel())
    m = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(batch.n_dof, batch.n_dof)).tocsr()
    m.sum_duplicates()
    return m


def _setup_geneo_impl(batch: SubdomainBatch, opts: GenEOOptions,
                      decomp=None, timers=None, a_csr=None
                      ) -> tuple[GenEOPreconditioner, GenEOStats]:
    import scipy.sparse as sp

    opts.validate()
    if opts.els2.type != "eigh":
        raise ValueError(f"els2 type {opts.els2.type!r} is not ported yet "
                         "(ROADMAP Queue 1, item 10); use eigh")

    def mark(name, t0):
        if timers is not None:
            timers.add(name, time.perf_counter() - t0)
        return time.perf_counter()

    device, dtype = batch.device, batch.dtype
    n_dom = batch.n_dom
    n_dof = batch.n_dof
    mask_np = batch.mask.cpu().numpy()
    mult_np = batch.mult.cpu().numpy()
    n_real = mask_np.sum(axis=1).astype(np.int64)

    # ----- level 1: factor Dirichlet (ASM..SRAS) or Robin (ORAS/SORAS) -----
    t = time.perf_counter()
    if opts.lvl1_oras:
        m_blocks = robin_blocks(batch, opts.optim)   # (14) of R4
    else:
        m_blocks = batch.a_dir                       # (1.30) of R1
    if opts.dls1.type in ("inverse", "inverse_pallas"):
        l1_kind = "inv"
        l1_factor = _device_inverse(m_blocks)
    elif opts.dls1.type == "lu":
        # batched LU with partial pivoting (the reference's MUMPS-LU route;
        # works for non-SPD user-supplied operators)
        l1_kind = "lu"
        l1_factor = bl.lu_factor(m_blocks)
    else:
        l1_kind = "chol"
        l1_factor = bl.cholesky_factor(m_blocks)
    del m_blocks
    _sync(device)
    mark("l1_minv", t)

    need_pou = opts.lvl2_num > 0 or opts.lvl1_ras
    pou = batch.pou if need_pou else None

    stats = GenEOStats(
        estim_dim_e=np.zeros(n_dom, np.int64),
        real_dim_e=np.zeros(n_dom, np.int64),
        nicolaides=np.zeros(n_dom, np.int64),
        tau_loc=np.full(n_dom, -1.0), gamma_loc=np.full(n_dom, -1.0))

    if opts.lvl2_num == 0:
        pc = GenEOPreconditioner(
            lvl1=opts.lvl1, lvl2=0, hybrid=False, eff_hybrid=False,
            dim_e=0, k_max=0, l1_kind=l1_kind, batch=batch,
            l1_factor=l1_factor, pou=pou, z_loc=None, colids=None,
            e_evecs=None, e_eig_inv=None,
            x0=torch.zeros(n_dof, dtype=dtype, device=device))
        return pc, stats

    # ----- level 2: batched local generalized eigenproblems (host) -----
    a_neu_np = batch.a_neu.cpu().numpy()
    a_dir_np = batch.a_dir.cpu().numpy()
    d_np = 1.0 / mult_np
    dadird = a_dir_np * d_np[:, :, None] * d_np[:, None, :]  # D A_Dir D
    cut = opts.cut
    problems = []  # (kind, A, B, thr[n_dom])
    if opts.lvl2_num == 1:
        # GenEO-1: A_Neu v = lambda (D A_Dir D) v, threshold tau
        # (Def 7.14 of R1; geneo.cpp:1270-1273)
        problems.append(("tau", a_neu_np, dadird, np.full(n_dom, opts.tau)))
    else:
        # GenEO-2 halves -geneo_cut between its two problems
        # (geneo.cpp:1275)
        if cut >= 2:
            cut = cut // 2
        a_rob = robin_blocks(batch, opts.optim).cpu().numpy()
        tl = _tau_loc(mult_np, mask_np, opts.tau, opts.cst)
        gl = _gamma_loc(decomp.adjacency() if decomp is not None else
                        np.zeros((n_dom, n_dom), dtype=bool),
                        n_dom, opts.gamma, opts.cst)
        stats.tau_loc, stats.gamma_loc = tl, gl
        # (19) of R4: A_Neu v = lambda A_Rob v, threshold tauLoc
        problems.append(("tau", a_neu_np, a_rob, tl))
        # (21) of R4: (D A_Dir D) v = lambda A_Rob v, threshold gammaLoc
        problems.append(("gamma", dadird, a_rob, gl))

    eps64 = np.finfo(np.float64).eps
    eps32 = np.finfo(np.float32).eps
    cols: list[list[np.ndarray]] = [[] for _ in range(n_dom)]
    evals: list[list[float]] = [[] for _ in range(n_dom)]

    for kind, a_p, b_p, thr in problems:
        t = time.perf_counter()
        steer = 1e6 if kind == "tau" else 1e-6
        w_np, v_np = bl.generalized_eigh_host(
            _with_pad_diag(a_p, mask_np, steer), b_p)
        if timers is not None:
            dt = time.perf_counter() - t
            timers.add("l2_eig", dt)
            timers.add(f"l2_{kind}_eig", dt)
        t = time.perf_counter()
        keep, estim = _select_columns(w_np, kind, thr, n_real,
                                      opts.no_syl, cut)
        if timers is not None:
            dt = time.perf_counter() - t
            timers.add("l2_syl", dt)
            timers.add(f"l2_{kind}_syl", dt)
        if not opts.no_syl:
            stats.estim_dim_e += estim
        if kind == "tau":
            # Nicolaides near-kernel test: quadratic forms 1^T A 1 / 1^T B 1
            ones_all = mask_np.astype(np.float64)
            num_all = np.einsum("dn,dnm,dm->d", ones_all, a_p, ones_all,
                                dtype=np.float64)
            den_all = np.einsum("dn,dnm,dm->d", ones_all, b_p, ones_all,
                                dtype=np.float64)
        for p in range(n_dom):
            kept_w = w_np[p, keep[p]]
            for i in keep[p]:
                cols[p].append(v_np[p, :, i])
                evals[p].append(float(w_np[p, i]))
            if kind == "tau" and n_real[p] > 0:
                # Nicolaides fallback: if no zero eigenvalue was kept, test
                # the constant vector for near-kernel membership
                # (geneo.cpp:897-955)
                no_zero = len(kept_w) > 0 and kept_w.min() >= eps64
                if no_zero:
                    num, den = num_all[p], den_all[p]
                    ratio = abs(num / den) if den != 0 else np.inf
                    if ratio <= eps32:
                        cols[p].append(mask_np[p].astype(np.float64))
                        evals[p].append(0.0)
                        stats.nicolaides[p] += 1
        del v_np

    # Empty local coarse set is forbidden: add the constant vector
    # (geneo.cpp:1303-1314).  Empty *domains* contribute no columns.
    for p in range(n_dom):
        if not cols[p] and n_real[p] > 0:
            cols[p].append(mask_np[p].astype(np.float64))
            evals[p].append(0.0)
            stats.nicolaides[p] += 1
        stats.real_dim_e[p] = len(cols[p])

    counts = stats.real_dim_e
    offsets = np.zeros(n_dom, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    dim_e = int(counts.sum())
    k_max = max(int(counts.max()), 1)

    # D-weighted coarse basis Z ((7.49) of R1; fillZE2L geneo.cpp:249-286)
    t = time.perf_counter()
    z_np = np.zeros((n_dom, batch.n_max, k_max), dtype=np.float64)
    colids_np = np.full((n_dom, k_max), dim_e, dtype=np.int64)
    for p in range(n_dom):
        for j, vec in enumerate(cols[p]):
            z_np[p, :, j] = np.where(mask_np[p], d_np[p] * vec, 0.0)
            colids_np[p, j] = offsets[p] + j
    stats.eigenvalues = evals

    # Global coarse basis (createZE2G role) and E = Z^T A Z (createEEig):
    # sparse PtAP on the host — the analogue of the reference's MatPtAP
    # (geneo.cpp:1033), since Z's columns live on their own domain only.
    gids_np = batch.gids.cpu().numpy()
    rows, cols_i, vals = [], [], []
    for p in range(n_dom):
        k = int(n_real[p])
        for j in range(int(counts[p])):
            rows.append(gids_np[p, :k])
            cols_i.append(np.full(k, offsets[p] + j, np.int64))
            vals.append(z_np[p, :k, j])
    zg_sp = sp.coo_matrix(
        (np.concatenate(vals) if vals else np.zeros(0),
         (np.concatenate(rows) if rows else np.zeros(0, np.int64),
          np.concatenate(cols_i) if cols_i else np.zeros(0, np.int64))),
        shape=(n_dof, dim_e)).tocsr()
    a_sp = _assembled_csr_from_batch(batch, n_real) if a_csr is None else a_csr
    t = mark("l2_z", t)
    e = np.asarray((zg_sp.T @ (a_sp @ zg_sp)).todense())
    e = 0.5 * (e + e.T)
    # E is assembled in float64 host arithmetic, so rank detection and
    # truncation use the float64 noise floor
    keep = prune_dependent_columns(e, np.float64)
    if keep is not None:
        # prune the dependent coarse columns so E is SPD and the PC is
        # nonsingular (vs MUMPS null-pivot fixing, geneo.cpp:76-92)
        stats.e_pruned = dim_e - keep.size
        kept_mask = np.zeros(dim_e, bool)
        kept_mask[keep] = True
        new_counts = np.array(
            [int(kept_mask[offsets[p]:offsets[p] + counts[p]].sum())
             for p in range(n_dom)], np.int64)
        new_offsets = np.zeros(n_dom, np.int64)
        np.cumsum(new_counts[:-1], out=new_offsets[1:])
        new_dim_e = int(new_counts.sum())
        new_k_max = max(int(new_counts.max()), 1)
        z2 = np.zeros((n_dom, batch.n_max, new_k_max), np.float64)
        colids_np = np.full((n_dom, new_k_max), new_dim_e, np.int64)
        for p in range(n_dom):
            js = np.flatnonzero(
                kept_mask[offsets[p]:offsets[p] + counts[p]])
            z2[p, :, :js.size] = z_np[p][:, js]
            colids_np[p, :js.size] = new_offsets[p] + np.arange(js.size)
            stats.eigenvalues[p] = [stats.eigenvalues[p][j] for j in js]
        e = e[np.ix_(keep, keep)]
        stats.real_dim_e = new_counts
        dim_e, k_max, z_np = new_dim_e, new_k_max, z2
    ev_np, ew_np, stats.e_null = factor_e(e, np.float64)

    def put(a, dt=dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    pc = GenEOPreconditioner(
        lvl1=opts.lvl1, lvl2=opts.lvl2_num, hybrid=opts.hybrid,
        eff_hybrid=opts.eff_hybrid, dim_e=dim_e, k_max=k_max,
        l1_kind=l1_kind, batch=batch, l1_factor=l1_factor, pou=pou,
        z_loc=put(z_np), colids=put(colids_np, torch.int64),
        e_evecs=put(ev_np), e_eig_inv=put(1.0 / ew_np),
        x0=torch.zeros(n_dof, dtype=dtype, device=device))
    _sync(device)
    mark("l2_e", t)
    return pc, stats
