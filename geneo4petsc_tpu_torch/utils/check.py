"""-geneo_chk invariant checks (reference check subsystem: checkSPD
geneo.cpp:782-840, checkRank :173-247, PoU positivity :988-997).

Violations raise CheckError (the reference SETERRABORTs).  The checks
run on the host in float64 on copies of the preconditioner's tensors,
wherever those live."""

from __future__ import annotations

import numpy as np


class CheckError(Exception):
    pass


def check_spd(a_dense: np.ndarray, info: str) -> None:
    a = np.asarray(a_dense, np.float64)
    if not np.allclose(a, a.T, atol=1e-10 * max(1.0, np.abs(a).max())):
        raise CheckError(f"GenEO - check SPD: {info} not symmetric")
    w = np.linalg.eigvalsh(0.5 * (a + a.T))
    if w.min() <= np.finfo(np.float64).eps * max(1.0, abs(w.max())):
        raise CheckError(
            f"GenEO - check SPD: {info} not SPD, bad eigen value {w.min()}")


def check_pou(pou: np.ndarray, mask: np.ndarray) -> None:
    d = np.asarray(pou)[np.asarray(mask)]
    if d.size and abs(d.min()) <= np.finfo(np.float64).eps:
        raise CheckError(
            f"GenEO - check D: bad partition of unity, min {d.min()}")


def check_rank_z(zg: np.ndarray) -> None:
    """Z = QR must have nonzero R diagonal (full column rank)."""
    if zg.shape[1] == 0:
        return
    r = np.linalg.qr(np.asarray(zg, np.float64), mode="r")
    d = np.abs(np.diag(r))
    if d.min() <= np.finfo(np.float64).eps * max(1.0, d.max()):
        i = int(np.argmin(d))
        raise CheckError(
            f"GenEO - check rank: Z = Q*R with R({i}, {i}) = {d.min()}")


def check_eigensolver(stats, tol: float, prefix: str = "check") -> None:
    """Abort when any KEPT eigenpair's residual exceeds the EPS tolerance
    analogue, after dumping the per-domain residual state (the
    checkEPSSolve discipline: dump solver state, then SETERRABORT —
    src/geneo.cpp:577-624)."""
    if stats is None or stats.lobpcg_res is None:
        return
    res = np.asarray(stats.lobpcg_res, np.float64)
    bad = np.flatnonzero(res > tol)
    if bad.size == 0:
        return
    width = len(str(res.size))
    for p in bad:
        with open(f"{prefix}{p:0{width}d}.eps.failure.log", "w") as f:
            f.write(f"eigensolver residual {res[p]:.6e} > tol {tol:g}\n")
            f.write(f"kept columns {int(stats.real_dim_e[p])}, "
                    f"nicolaides {int(stats.nicolaides[p])}\n")
            if stats.eigenvalues:
                f.write("kept eigenvalues: "
                        + " ".join(f"{w:.6e}"
                                   for w in stats.eigenvalues[p]) + "\n")
    raise CheckError(
        f"GenEO - check EPS: {bad.size} domain(s) with unconverged kept "
        f"eigenpairs (max residual {res.max():.3e} > {tol:g}); state "
        f"dumped to {prefix}*.eps.failure.log")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_checks(assembled, pc, pc_type: str,
               spd_limit: int = 3000, stats=None,
               eps_tol: float = 1e-3) -> None:
    """Run the -geneo_chk battery (sized-gated dense SPD checks)."""
    if assembled.n_dof <= spd_limit:
        check_spd(assembled.a_csr.toarray(), "A")
    if pc_type != "geneo" or pc is None:
        return
    check_eigensolver(stats, eps_tol)
    mask = _host(pc.batch.mask)
    if pc.pou is not None:
        check_pou(_host(pc.pou), mask)
    if pc.z_loc is not None and pc.dim_e:
        gids = _host(pc.batch.gids)
        z = _host(pc.z_loc).astype(np.float64)
        colids = _host(pc.colids)
        zg = np.zeros((pc.batch.n_dof, pc.dim_e))
        for p in range(pc.batch.n_dom):
            for j in range(z.shape[2]):
                c = colids[p, j]
                if c < pc.dim_e:
                    k = int(mask[p].sum())
                    zg[gids[p, :k], c] += z[p, :k, j]
        check_rank_z(zg)
