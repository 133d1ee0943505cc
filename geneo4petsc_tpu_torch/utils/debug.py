"""-geneo_dbg debug-file subsystem (reference: per-rank `debug<rank>.*`
files dumping ADir/ANeu/ARob, DADirD, eigenvalues, Z, E, DOF maps and
intersections — SURVEY.md §5.5, geneo.cpp:2501-2506 naming).

This port writes the same taxonomy as the JAX package, one file per
domain with zero-padded domain ids in the name, plus global Z/E files.
Level 1 dumps timings; level 2 dumps full setup artifacts.  Tensors are
copied to the host and written in float64, wherever they live.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t, dtype=None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _fname(prefix: str, p: int, n_dom: int, suffix: str) -> str:
    width = len(str(n_dom))
    return f"{prefix}{p:0{width}d}.{suffix}"


def _write_mat(prefix, p, n_dom, suffix, dense, fmt):
    """One per-domain matrix artifact in the selected viewer format
    (log = %.12g text, bin = PetscViewerBinary AIJ, mat = Matlab)."""
    from . import petsc_format as pf

    if fmt == "bin":
        pf.write_mat_bin(_fname(prefix, p, n_dom, suffix[:-3] + "bin"),
                         dense)
    elif fmt == "mat":
        with open(_fname(prefix, p, n_dom, suffix[:-3] + "m"), "w") as f:
            f.write(pf.format_mat_matlab(dense, suffix.split(".")[-2]))
    else:
        np.savetxt(_fname(prefix, p, n_dom, suffix), dense, fmt="%.12g")


def dump_setup(pc, stats, decomp=None, prefix: str = "debug",
               level: int = 2, fmt: str = "log",
               tau: float = 0.1) -> None:
    """Write per-domain setup artifacts (called when -geneo_dbg D >= 2).

    fmt selects the viewer format for matrix artifacts: log (text), bin
    (real PetscViewerBinary — loadable with VecLoad/MatLoad), mat
    (PETSC_VIEWER_ASCII_MATLAB).  `tau` reproduces the sylvester matrix
    A_Neu - tau * (D A_Dir D) + its inertia (the reference's
    sylvester/inertia dump taxonomy, geneo.cpp:2501-2506)."""
    if level < 2:
        return
    batch = pc.batch
    n_dom = batch.n_dom
    mask = _host(batch.mask)
    gids = _host(batch.gids)
    mult = _host(batch.mult)
    a_neu = _host(batch.a_neu, np.float64)
    a_dir = None if batch.a_dir is None \
        else _host(batch.a_dir, np.float64)

    for p in range(n_dom):
        k = int(mask[p].sum())
        _write_mat(prefix, p, n_dom, "setup.ANeu.log", a_neu[p, :k, :k],
                   fmt)
        if a_dir is not None:
            _write_mat(prefix, p, n_dom, "setup.ADir.log",
                       a_dir[p, :k, :k], fmt)
        if a_dir is not None and pc.lvl2:
            # sylvester matrix + inertia (estimateNumberOfEigenValues,
            # geneo.cpp:452-560): S = A_Neu - tau * D A_Dir D; the
            # negative-eigenvalue count is the tau-window estimate
            d = 1.0 / np.maximum(mult[p, :k], 1.0)
            b_mat = a_dir[p, :k, :k] * d[:, None] * d[None, :]
            s = a_neu[p, :k, :k] - tau * b_mat
            _write_mat(prefix, p, n_dom, "setup.sylvester.tau.log", s, fmt)
            ew = np.linalg.eigvalsh(0.5 * (s + s.T))
            neg = int((ew < 0).sum())
            zero = int((np.abs(ew) <= 1e-12 * max(1.0,
                                                  abs(ew).max())).sum())
            with open(_fname(prefix, p, n_dom,
                             "setup.sylvester.inertia.log"), "w") as f:
                f.write(f"inertia: {neg} negative, {zero} zero, "
                        f"{k - neg - zero} positive eigen values\n")
                f.write(f"estimated nb of eigen values < tau={tau:g}: "
                        f"{neg}\n")
        with open(_fname(prefix, p, n_dom, "input.dof.log"), "w") as f:
            for i in range(k):
                f.write(f"DOF {i}: global index {gids[p, i]}, "
                        f"multiplicity {int(mult[p, i])}\n")

    if pc.z_loc is not None:
        z = _host(pc.z_loc, np.float64)
        colids = _host(pc.colids)
        for p in range(n_dom):
            k = int(mask[p].sum())
            nc = int((colids[p] < pc.dim_e).sum())
            _write_mat(prefix, p, n_dom, "setup.Z.log",
                       z[p, :k, :nc] if nc else np.zeros((k, 0)), fmt)
            if stats is not None and p < len(stats.eigenvalues):
                with open(_fname(prefix, p, n_dom, "setup.tau.ev.log"),
                          "w") as f:
                    evs = stats.eigenvalues[p]
                    f.write(f"nb of eigen values added to Z: {len(evs)}\n")
                    for i, ev in enumerate(evs):
                        f.write(f"eigen value {i} added to Z: {ev:g}\n")
        if pc.e_evecs is not None:
            ew_inv = _host(pc.e_eig_inv, np.float64)
            with open(f"{prefix}.setup.E.eig.log", "w") as f:
                f.write(f"dim E: {pc.dim_e}\n")
                nz = int((ew_inv > 0).sum())
                f.write(f"numerical rank: {nz}\n")

    if decomp is not None:
        for p in range(n_dom):
            with open(_fname(prefix, p, n_dom, "input.intersect.log"),
                      "w") as f:
                for q in range(decomp.n_dom):
                    if p == q:
                        continue
                    for loc in decomp.intersections[p][q]:
                        gid = decomp.dom_nodes[p][loc]
                        f.write(f"domains {p} and {q} intersect in global "
                                f"index {gid} (local index {loc})\n")


def dump_apply(pc, x, prefix: str = "debug", apply_idx: int = 1,
               fmt: str = "log") -> None:
    """Per-apply scatter input/output dumps (the reference writes XLoc
    before/after each local solve under -geneo_dbg >= 2,
    geneo.cpp:2501-2506 naming).

    As in the JAX package, ONE representative apply on ``x`` stands in
    for every apply of the solve: it dumps the scatter input (gathered
    local copies) of each domain and the level-1 result gathered back
    (scatter-add) to the global vector."""
    from . import petsc_format as pf

    batch = pc.batch
    n_dom = batch.n_dom
    mask = _host(batch.mask)
    xt = torch.as_tensor(np.asarray(x)).to(batch.device, batch.dtype)
    xl = _host(batch.gather(xt), np.float64)              # scatter fwd
    yl_g = _host(pc._local_solve(xt), np.float64)         # full L1 (global)
    tag = f"apply{apply_idx:03d}"
    for p in range(n_dom):
        k = int(mask[p].sum())
        if fmt == "bin":
            pf.write_vec_bin(_fname(prefix, p, n_dom,
                                    f"{tag}.scatter.in.bin"), xl[p, :k])
        else:
            np.savetxt(_fname(prefix, p, n_dom, f"{tag}.scatter.in.log"),
                       xl[p, :k], fmt="%.12g")
    if fmt == "bin":
        pf.write_vec_bin(f"{prefix}.{tag}.scatter.out.bin", yl_g)
    else:
        np.savetxt(f"{prefix}.{tag}.scatter.out.log", yl_g, fmt="%.12g")


def dump_failure(result, ksp, pc_name: str, stats=None,
                 prefix: str = "debug") -> None:
    """Dump Krylov + PC state on a DIVERGED_* outcome, even when debugging
    is off — the checkKSPSolve discipline (KSPView/BVView to debug files
    before aborting, src/geneo.cpp:1397-1433, :577-624)."""
    from ..krylov import common as kcm

    with open(f"{prefix}.failure.ksp.log", "w") as f:
        f.write(f"reason: {kcm.reason_string(int(result.reason))} "
                f"({int(result.reason)})\n")
        f.write(f"iterations: {int(result.its)}\n")
        f.write(f"residual norm: {float(result.rnorm):.12e}\n")
        f.write(f"ksp type: {ksp.type}, rtol {ksp.rtol:g}, atol "
                f"{ksp.atol:g}, dtol {ksp.dtol:g}, max_it {ksp.max_it}\n")
        f.write(f"pc: {pc_name}\n")
        if stats is not None:
            f.write(f"dim_e: {int(stats.real_dim_e.sum())} "
                    f"(nicolaides {int(stats.nicolaides.sum())}, "
                    f"e_null {stats.e_null}, e_pruned {stats.e_pruned})\n")
            if stats.lobpcg_res is not None:
                f.write("eigensolver kept-pair residual max: "
                        f"{float(np.max(stats.lobpcg_res)):.6e}\n")
        h = _host(torch.as_tensor(result.history), np.float64)
        h = h[~np.isnan(h)]
        f.write("residual history:\n")
        for i, r in enumerate(h):
            f.write(f"  {i}: {r:.12e}\n")


def dump_timing(timers, prefix: str = "debug") -> None:
    """Per-run timing dump (destroyGenEOPC writes debug*.timing.log when
    -geneo_dbg >= 1, geneo.cpp:2189-2215)."""
    with open(f"{prefix}.timing.log", "w") as f:
        for name, val in sorted(timers.phases.items()):
            f.write(f"{name}: {val:.5f} s\n")
