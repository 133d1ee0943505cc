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
    host (float64 LAPACK, ``els2 eigh``), or batched LOBPCG on the
    batch's device with Sylvester-inertia candidate counts (``els2
    lobpcg``, the iterative route)
  * VecScatter halo exchange    ->  gather / table scatter-add
  * rank-0 offload of Z and E   ->  replication (the tiny coarse
    factorization lives next to the batch; -geneo_offload is a no-op)

Setup is host-orchestrated: the dense eigensolves, the coarse basis and
E = Z^T A Z run in NumPy/SciPy; the level-1 factorization, and with
``els2 lobpcg`` on a card the pencils, inertia counts and LOBPCG, run on
the batch's device, and the finished products stay there.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..assembly.assemble import SubdomainBatch, robin_blocks
from ..config import GenEOOptions
from ..ops import batched_linalg as bl
from ..ops.lobpcg import batched_lobpcg, default_start
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
    # before the pruning pass
    raw_dim_e: np.ndarray | None = None
    # [n_dom] LOBPCG relative residual, max over the kept pairs
    # (None for the dense-eigh route)
    lobpcg_res: np.ndarray | None = None
    # per GenEO pencil of the structured path ("tau", "gamma"): the
    # (solves, iterations) of the PCG that preconditions its
    # shift-invert, None for a pencil whose preconditioner runs no PCG
    # (None on the routes that solve no pencil)
    shift_invert_pcg: dict | None = None


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
        w = self.batch.coarse_sum(x.new_zeros(self.dim_e + 1).index_add_(
            0, self.colids.reshape(-1), ztx.reshape(-1))[:-1])
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


def _steer_pad(a: torch.Tensor, mask: torch.Tensor, value: float
               ) -> torch.Tensor:
    """Tensor twin of ``_with_pad_diag`` on ``a``'s device."""
    out = a.clone()
    diag = out.diagonal(dim1=-2, dim2=-1)
    diag.copy_(torch.where(mask, diag, (diag - 1.0) + value))
    return out


def _dadird_device(batch: SubdomainBatch) -> torch.Tensor:
    """D A_Dir D (buildCoarseSpaceWithGenEO, geneo.cpp:1243-1247)."""
    d = 1.0 / batch.mult
    return batch.a_dir * d[:, :, None] * d[:, None, :]


def _pencil_tau_device(batch: SubdomainBatch, steer: float):
    """GenEO-1 tau pencil on the batch's device: (A_Neu steered,
    D A_Dir D)."""
    return _steer_pad(batch.a_neu, batch.mask, steer), _dadird_device(batch)


def _pencil_g2_device(batch: SubdomainBatch, optim: float, kind: str):
    """GenEO-2 pencils on the batch's device, in LOBPCG (smallest
    eigenpair) form:

    tau:   (A_Neu steered, A_Rob)            — (19) of R4, smallest lambda
    gamma: (A_Rob steered, D A_Dir D)        — (21) of R4 REVERSED: its
           largest lambda are the smallest mu = 1/lambda of the swapped
           pencil, which is what LOBPCG computes.  Pad slots get a 1e6
           diagonal on the steered side so they never enter the window."""
    a_rob = robin_blocks(batch, optim)           # _robin_from_arrays
    if kind == "tau":
        return _steer_pad(batch.a_neu, batch.mask, 1e6), a_rob
    return _steer_pad(a_rob, batch.mask, 1e6), _dadird_device(batch)


def _quad_forms(a, b, mask: torch.Tensor):
    """Nicolaides near-kernel quadratic forms 1^T A 1 and 1^T B 1 per
    domain over the masked slots, in float64 (host arrays or device
    tensors)."""
    if isinstance(a, np.ndarray):
        ones = mask.cpu().numpy().astype(np.float64)
        return (np.einsum("dn,dnm,dm->d", ones, a, ones, dtype=np.float64),
                np.einsum("dn,dnm,dm->d", ones, b, ones, dtype=np.float64))
    ones = mask.to(torch.float64)

    def form(m):
        return torch.einsum("dn,dnm,dm->d", ones, m.double(),
                            ones).cpu().numpy()

    return form(a), form(b)


def _device_inverse(m_blocks: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse on the blocks' device: Cholesky (with the
    jitter fallback) + cholesky_inverse, row-major as K1 reads it."""
    return torch.cholesky_inverse(bl.cholesky_factor(m_blocks)).contiguous()


# domains per LOBPCG run on a card: caps the device memory of the pencil
# staging at large domain counts
LOBPCG_CHUNK = 1024


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


# the port's measurement of the replication wall (perf/measure_coarse.py)
COARSE_SCALING = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perf", "coarse_scaling.json")


@functools.lru_cache(maxsize=None)
def _wall_from(path: str) -> int:
    try:
        with open(path) as f:
            return int(json.load(f)["replication_wall_dim_e"])
    except FileNotFoundError:
        return 16384


def coarse_replication_wall() -> int:
    """dim_e above which the replicated coarse solve leaves its measured
    comfort zone (host O(dim_e^3) factorization / device factor memory).
    Measured on the card's machine by perf/measure_coarse.py into
    perf/coarse_scaling.json (read once); 16384 when the file is absent.
    The reference solves the same problem with distributed MUMPS
    (src/geneo.cpp:1028-1095); the mitigations above the wall are the
    E1/E2 efficient-hybrid family (coarse apply per outer restart) and
    larger/fewer subdomains.  E is replicated on every rank of a
    multi-rank run, so the wall is per rank."""
    return _wall_from(COARSE_SCALING)


def warn_coarse_replication(dim_e: int) -> None:
    """WRNG on stderr (stdout is the golden-diffed protocol) when a run's
    coarse space exceeds the measured replication wall."""
    wall = coarse_replication_wall()
    if dim_e > wall:
        print(f"WRNG: dim_e = {dim_e} exceeds the measured replicated-"
              f"coarse-solve wall ({wall}): the O(dim_e^3) host "
              "factorization and the dense device factor dominate "
              "(geneo4petsc_tpu_torch/perf/coarse_scaling.json). Prefer "
              "E1/E2 (efficient hybrid), raise tau/cut selectivity, or use "
              "fewer/larger subdomains; the reference's answer at this "
              "scale is a distributed MUMPS factorization "
              "(src/geneo.cpp:1028-1095).", file=sys.stderr)


def setup_geneo(batch: SubdomainBatch, opts: GenEOOptions,
                b: torch.Tensor | None = None, decomp=None, timers=None,
                a_csr=None, lobpcg_start=None
                ) -> tuple[GenEOPreconditioner, GenEOStats]:
    """Full preconditioner setup (PCSetUp -> setUpGenEOPC path).

    The level-1 factorization runs on the batch's device.  With ``els2
    eigh`` the level-2 eigensolves run on the host in float64 (the
    reference's cost model: ARPACK/MUMPS/LAPACK setup on CPU,
    src/geneo.cpp:626-780); with ``els2 lobpcg`` the pencils, the
    Sylvester inertia counts and the batched LOBPCG run on the batch's
    device when it is a card (in chunks of ``LOBPCG_CHUNK`` domains), on
    the host pencils otherwise.  The coarse basis Z and E = Z^T A Z are
    built on the host in float64.  For the efficient-hybrid variants
    (E1/E2) and a given ``b``, the initial guess is x0 = Q b
    (setUpLevel2, geneo.cpp:1601-1604).

    ``lobpcg_start(d, n, k, dtype)``: the [d, n, k] Gaussian start block
    of one LOBPCG run, before preconditioning (default
    ``ops.lobpcg.default_start``, a torch.Generator seeded 0); one draw
    per domain chunk.

    ``timers``: optional utils.timers.Timers — records the reference's
    per-phase setup taxonomy (l1_minv, l2_{tau,gamma}_{syl,eig},
    l2_{syl,eig,z,e}; geneo.hpp:113-123) and, on the LOBPCG route, the
    split of l2_eig into l2_pencil, l2_inertia and l2_lobpcg."""
    pc, stats = _setup_geneo_impl(batch, opts, decomp, timers, a_csr,
                                  lobpcg_start)
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


def _lobpcg_problem(batch: SubdomainBatch, opts: GenEOOptions, kind: str,
                    host_pencil, thr: np.ndarray, cut: int, timers,
                    start) -> dict:
    """One GenEO eigenproblem by batched LOBPCG (the ARPACK-equivalent
    iterative route, SURVEY hard part #1): k candidates per domain, from
    -geneo_cut, or 8 under -geneo_no_syl, or the Sylvester inertia of
    (A - theta B) through batched LDL^T (Cholesky cost, the estimate the
    reference feeds ARPACK's nev, geneo.cpp:502-560, 626-661).

    The gamma problem wants the LARGEST pencil eigenvalues; LOBPCG
    computes the smallest, so it runs on the SWAPPED pencil (both sides
    SPD) and the eigenvalues come back as lambda = 1/mu.  On a card the
    pencils are built there from the batch (``host_pencil`` is then
    None); otherwise ``host_pencil`` gives the host (A, B) pair, already
    steered.  Returns w [d, k], v [d, n, k] and res [d, k] (host float64,
    guard columns dropped), the inertia estimates (or None) and the
    Nicolaides quadratic forms of the tau problem (or None)."""
    def mark(name, t0):
        if timers is not None:
            timers.add(name, time.perf_counter() - t0)
        return time.perf_counter()

    device, dtype = batch.device, batch.dtype
    reversed_pencil = kind == "gamma"
    t = time.perf_counter()
    if host_pencil is None:
        if opts.lvl2_num == 1:
            a_full, b_full = _pencil_tau_device(batch, 1e6)
        else:
            a_full, b_full = _pencil_g2_device(batch, opts.optim, kind)
        _sync(device)
    else:
        a_full, b_full = (torch.from_numpy(np.ascontiguousarray(m))
                          for m in host_pencil)
    t = mark("l2_pencil", t)
    # the quadratic forms see only masked slots: the steered pad
    # diagonal does not enter them
    forms = _quad_forms(*(host_pencil or (a_full, b_full)), batch.mask) \
        if kind == "tau" else None

    estim = None
    if cut > 0:
        k_cand = cut
    elif opts.no_syl:
        k_cand = 8
    else:
        # the swapped gamma pencil wants mu < 1/thr: the same negative
        # inertia count on its own arrays
        thr_used = 1.0 / np.maximum(thr, 1e-12) if reversed_pencil else thr
        th = torch.tensor(thr_used, dtype=a_full.dtype, device=a_full.device)
        n_neg, _pos = bl.ldlt_inertia(a_full - th[:, None, None] * b_full,
                                      batch.mask.to(a_full.device))
        estim = n_neg.cpu().numpy().astype(np.int64)
        k_cand = int(np.clip(estim.max(), 1, 32))
        t = mark("l2_inertia", t)
    k_cand = min(k_cand, batch.n_max)
    # guard vectors: GenEO-2 halves the candidate count per pencil and its
    # near-threshold spectra are clustered — a few extra working columns
    # sharpen the wanted Ritz pairs (GenEO-1 stays guard-free: its
    # windows are gapped)
    k_run = min(k_cand + (4 if opts.lvl2_num == 2 else 0), batch.n_max)
    max_it = min(int(opts.els2.max_it), 200) \
        if opts.els2.max_it < 10000 else 50
    shift = float(np.mean(1.0 / np.maximum(thr, 1e-12))
                  if reversed_pencil else np.mean(thr))
    # on a card, domain chunks cap the memory of the pencil staging
    n_dom = batch.n_dom
    chunk = LOBPCG_CHUNK if device.type == "cuda" else n_dom
    w_parts, v_parts, r_parts = [], [], []
    for lo in range(0, n_dom, chunk):
        hi = min(lo + chunk, n_dom)
        w, v, res = batched_lobpcg(
            a_full[lo:hi], b_full[lo:hi], k=k_run, max_it=max_it,
            shift=shift, x0=start(hi - lo, batch.n_max, k_run, dtype))
        w_parts.append(w[:, :k_cand].double().cpu().numpy())
        v_parts.append(v[:, :, :k_cand].double().cpu().numpy())
        r_parts.append(res[:, :k_cand].double().cpu().numpy())
    w_np = np.concatenate(w_parts, axis=0)
    if reversed_pencil:
        # map the swapped-pencil mu back to lambda = 1/mu
        w_np = 1.0 / np.maximum(w_np, np.finfo(np.float64).tiny)
    mark("l2_lobpcg", t)
    return dict(w=w_np, v=np.concatenate(v_parts, axis=0),
                res=np.concatenate(r_parts, axis=0), estim=estim,
                forms=forms)


def _setup_geneo_impl(batch: SubdomainBatch, opts: GenEOOptions,
                      decomp=None, timers=None, a_csr=None,
                      lobpcg_start=None
                      ) -> tuple[GenEOPreconditioner, GenEOStats]:
    import scipy.sparse as sp

    opts.validate()
    if batch.dtype == torch.float32:
        bl.require_full_f32()

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

    # ----- level 2: batched local generalized eigenproblems -----
    use_lobpcg = opts.els2.type == "lobpcg"
    # the LOBPCG route builds its pencils on the card from the batch; the
    # host routes build them in NumPy
    host = not (use_lobpcg and device.type == "cuda")
    if host:
        a_neu_np = batch.a_neu.cpu().numpy()
        a_dir_np = batch.a_dir.cpu().numpy()
        d_np = 1.0 / mult_np
        dadird = a_dir_np * d_np[:, :, None] * d_np[:, None, :]  # D A_Dir D
    cut = opts.cut
    problems = []  # (kind, thr[n_dom], host (A, B) or None)
    if opts.lvl2_num == 1:
        # GenEO-1: A_Neu v = lambda (D A_Dir D) v, threshold tau
        # (Def 7.14 of R1; geneo.cpp:1270-1273)
        problems.append(("tau", np.full(n_dom, opts.tau),
                         (a_neu_np, dadird) if host else None))
    else:
        # GenEO-2 halves -geneo_cut between its two problems
        # (geneo.cpp:1275)
        if cut >= 2:
            cut = cut // 2
        a_rob = robin_blocks(batch, opts.optim).cpu().numpy() if host \
            else None
        tl = _tau_loc(mult_np, mask_np, opts.tau, opts.cst)
        gl = _gamma_loc(decomp.adjacency() if decomp is not None else
                        np.zeros((n_dom, n_dom), dtype=bool),
                        n_dom, opts.gamma, opts.cst)
        stats.tau_loc, stats.gamma_loc = tl, gl
        # (19) of R4: A_Neu v = lambda A_Rob v, threshold tauLoc
        problems.append(("tau", tl, (a_neu_np, a_rob) if host else None))
        # (21) of R4: (D A_Dir D) v = lambda A_Rob v, threshold gammaLoc
        problems.append(("gamma", gl, (dadird, a_rob) if host else None))

    eps64 = np.finfo(np.float64).eps
    eps32 = np.finfo(np.float32).eps
    cols: list[list[np.ndarray]] = [[] for _ in range(n_dom)]
    evals: list[list[float]] = [[] for _ in range(n_dom)]

    for kind, thr, pencil in problems:
        t = time.perf_counter()
        if use_lobpcg:
            if pencil is not None:
                a_p, b_p = pencil
                # the gamma problem runs on the swapped pencil
                pencil = ((_with_pad_diag(a_p, mask_np, 1e6), b_p)
                          if kind == "tau" else
                          (_with_pad_diag(b_p, mask_np, 1e6), a_p))
            sol = _lobpcg_problem(batch, opts, kind, pencil, thr, cut,
                                  timers, lobpcg_start or default_start)
            w_np, v_np = sol["w"], sol["v"]
        else:
            a_p, b_p = pencil
            steer = 1e6 if kind == "tau" else 1e-6
            w_np, v_np = bl.generalized_eigh_host(
                _with_pad_diag(a_p, mask_np, steer), b_p)
        if timers is not None:
            dt = time.perf_counter() - t
            timers.add("l2_eig", dt)
            timers.add(f"l2_{kind}_eig", dt)
        t = time.perf_counter()
        if use_lobpcg:
            # every computed candidate inside the window is kept: [0, tau]
            # / [gamma, inf), the reference's post-solve filter
            # (geneo.cpp:713-714); no inertia estimates under a cut or
            # -geneo_no_syl (the no_syl convention)
            keep = [np.flatnonzero(w_np[p] <= thr[p]) if kind == "tau"
                    else np.flatnonzero(w_np[p] >= thr[p])
                    for p in range(n_dom)]
            estim = sol["estim"]
            # kept-pair residuals (the checkEPSSolve role,
            # geneo.cpp:577-624): the CLI warns above the EPS tolerance
            kept_res = np.array([sol["res"][p, keep[p]].max()
                                 if keep[p].size else 0.0
                                 for p in range(n_dom)])
            stats.lobpcg_res = kept_res if stats.lobpcg_res is None \
                else np.maximum(stats.lobpcg_res, kept_res)
        else:
            keep, estim = _select_columns(w_np, kind, thr, n_real,
                                          opts.no_syl, cut)
        if timers is not None:
            dt = time.perf_counter() - t
            timers.add("l2_syl", dt)
            timers.add(f"l2_{kind}_syl", dt)
        if not opts.no_syl and estim is not None:
            stats.estim_dim_e += estim
        if kind == "tau":
            # Nicolaides near-kernel test: quadratic forms 1^T A 1 / 1^T B 1
            num_all, den_all = sol["forms"] if use_lobpcg else \
                _quad_forms(a_p, b_p, batch.mask)
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
    stats.raw_dim_e = counts.copy()
    offsets = np.zeros(n_dom, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    dim_e = int(counts.sum())
    k_max = max(int(counts.max()), 1)

    # D-weighted coarse basis Z ((7.49) of R1; fillZE2L geneo.cpp:249-286)
    t = time.perf_counter()
    d_np = 1.0 / mult_np
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
    warn_coarse_replication(dim_e)
    # the Cholesky path is gated in the precision the factors are applied
    # in; the truncation floor is E's own float64
    ev_np, ew_np, stats.e_null = factor_e(
        e, torch.empty((), dtype=dtype).numpy().dtype, e_dtype=np.float64)

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
