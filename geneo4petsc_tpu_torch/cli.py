"""CLI driver — the L6 layer of the reference (main/checkArguments/usage,
src/geneo4PETSc.cpp:1396-1633) on the PyTorch port.

Same flag surface as the JAX package's CLI:
  --inpFileA F --inpEps E --inpLibA L A --inpFileB F --metisDual
  --metisNodal --addOverlap L --debug F --verbose V --timing --shortRes
  --cmdLine --help --nbPart N
  --nbDevices D|auto
plus PETSc-style options consumed from the remaining argv:
  -pc_type {geneo,bjacobi,mg,none} -ksp_type {gmres,cg} -ksp_rtol
  -ksp_atol -ksp_divtol -ksp_max_it -ksp_gmres_restart -options_left
  -pc_mg_cycle_type -pc_mg_smoothdown -pc_mg_smoothup
  -geneo_lvl L1,L2 -geneo_optim -geneo_tau -geneo_gamma -geneo_cst
  -geneo_cut -geneo_no_syl -geneo_offload -dls1_type -els2_type
  -geneo_dbg F,D -geneo_chk F
and one flag of its own:
  --device cpu|cuda   (default cuda; a cuda run without a card raises)

``--nbDevices D`` runs the solve on D ranks (the reference's ``mpirun
-n D``, parallel/): in a torch.distributed group (GENEO_COORDINATOR /
GENEO_NUM_PROCS / GENEO_PROC_ID) this process is one rank; otherwise the
CLI launches D local ranks itself, NCCL with one card a rank on cuda,
gloo on cpu.  Only rank 0 prints.  Output protocol (INFO/TIME/WRNG/CMD
lines, verbose dumps) matches the reference's formats.
"""

from __future__ import annotations

import io
import sys
import time

import numpy as np
import torch

from .config import DriverOptions, GenEOOptions, KSPOptions
from .io import element_input as ei
from .io.plugin import get_lib_input
from .krylov import common as kcm
from .utils import petsc_format as pf
from .utils.timers import Timers

USAGE = """
usage: geneo4petsc_tpu_torch is the PyTorch/CUDA port of geneo4petsc_tpu

  --help,         print help
  --inpFileA F,   input file F describing the A matrix (mandatory unless --inpLibA)
  --inpEps E,     epsilon used to tune the elementary matrix (defaults to 0.0001)
  --inpLibA L A,  input generator: registered name (laplacian, heat, graph,
                  elasticity), python path
                  (module:function), or .so implementing the flat-C ABI
                  A: '#'-separated arguments passed to the generator
  --inpFileB F,   input file F describing the B vector
  --metisDual,    partition by elements (each element in exactly one partition)
  --metisNodal,   partition by nodes (elements may belong to several partitions)
  --addOverlap L, add L layers of overlap at each domain border
  --nbPart N,     number of subdomains (the reference's mpirun -n N)
  --structured GX,GY,GZ, structured scale path on a GX x GY x GZ box
                  decomposition (--inpLibA laplacian|heat|elasticity,
                  -pc_type geneo)
  --device D,     cuda (default) or cpu
  --nbDevices D,  run the solve on D ranks, one device each (D = int or
                  'auto'); the mpirun -n analogue
  --debug F,      create debug files (F = log, bin or mat)
  --verbose V,    V=1: dump X; V=2: dump A, B and X
  --timing,       print timing
  --shortRes,     print short result status (stable golden-test output)
  --cmdLine,      print command line at the end of the log

  -pc_type P           bjacobi (default) | mg | geneo | none
  -pc_mg_cycle_type v|w  -pc_mg_smoothdown N  -pc_mg_smoothup N
  -ksp_type K          gmres | cg
  -ksp_rtol/-ksp_atol/-ksp_divtol/-ksp_max_it/-ksp_gmres_restart
  -geneo_lvl L1,L2     L1 = ASM|RAS|SRAS|ORAS|SORAS; L2 = 0|1|H1|E1|2|H2|E2
  -geneo_optim A  -geneo_tau T  -geneo_gamma G  -geneo_cst  -geneo_cut C
  -geneo_no_syl  -geneo_offload
  -dls1_type T         cholesky | lu | inverse | inverse_pallas
  -els2_type T         eigh | lobpcg
  -els2_eps_max_it N  -els2_eps_tol T
  -geneo_dbg F,D       debug files (F = log|bin|mat) at level D (1: timing,
                       2: setup artifacts and one apply)
  -geneo_chk F         check SPD, PoU, rank of Z and the eigensolver
"""

class CLIError(Exception):
    pass


def parse_args(argv: list[str]):
    drv = DriverOptions()
    ksp = KSPOptions(rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000)
    gen = GenEOOptions()
    pc_type = None
    check = False
    dbg_level = 0
    dbg_fmt = "log"
    user_cmd = "geneo4petsc_tpu_torch " + " ".join(argv)

    def need(i, name):
        if i >= len(argv):
            raise CLIError(f"Error: invalid command line, {name}")
        return argv[i]

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--help":
            raise CLIError("__help__")
        elif a == "--nbDevices":
            i += 1
            v = need(i, a)
            if v == "auto":
                drv.n_devices = v
            else:
                drv.n_devices = int(v)
                if drv.n_devices < 1:
                    raise CLIError("Error: invalid option --nbDevices")
        elif a == "--debug":
            drv.debug = True
            i += 1
            f = need(i, a)
            drv.debug_bin = f == "bin"
            drv.debug_mat = f == "mat"
        elif a == "--structured":
            i += 1; drv.structured = need(i, a)
        elif a == "--inpFileA":
            i += 1; drv.inp_file_a = need(i, a)
        elif a == "--inpEps":
            i += 1; drv.inp_eps = float(need(i, a))
        elif a == "--inpLibA":
            i += 1; drv.inp_lib_a = need(i, a)
            # reference form: --inpLibA L A (two tokens); also accept the
            # explicit --inpLibArg A form
            if i + 1 < len(argv) and argv[i + 1] != "--inpLibArg":
                i += 1; drv.inp_lib_arg = need(i, a)
        elif a == "--inpLibArg":
            i += 1; drv.inp_lib_arg = need(i, a)
        elif a == "--inpFileB":
            i += 1; drv.inp_file_b = need(i, a)
        elif a == "--metisDual":
            drv.metis_dual = True
        elif a == "--metisNodal":
            drv.metis_dual = False
        elif a == "--addOverlap":
            i += 1; drv.add_overlap = int(need(i, a))
        elif a == "--nbPart":
            i += 1; drv.n_parts = int(need(i, a))
        elif a == "--device":
            i += 1; drv.device = need(i, a)
            if drv.device not in ("cpu", "cuda"):
                raise CLIError("Error: invalid option --device (cpu|cuda)")
        elif a == "--verbose":
            i += 1; drv.verbose = int(need(i, a))
        elif a == "--timing":
            drv.timing = True
        elif a == "--shortRes":
            drv.short_res = True
        elif a == "--cmdLine":
            drv.cmd_line = True
        elif a == "-pc_type":
            i += 1; pc_type = need(i, a)
            if pc_type == "geneo":
                drv.use_mat_mpi = False
        elif a == "-pc_mg_cycle_type":
            i += 1; drv.mg_cycle_type = need(i, a)
        elif a == "-pc_mg_smoothdown":
            i += 1; drv.mg_smooth_down = int(need(i, a))
        elif a == "-pc_mg_smoothup":
            i += 1; drv.mg_smooth_up = int(need(i, a))
        elif a == "-ksp_type":
            i += 1; ksp.type = need(i, a)
        elif a == "-ksp_rtol":
            i += 1; ksp.rtol = float(need(i, a))
        elif a == "-ksp_atol":
            i += 1; ksp.atol = float(need(i, a))
        elif a == "-ksp_divtol":
            i += 1; ksp.dtol = float(need(i, a))
        elif a == "-ksp_max_it":
            i += 1; ksp.max_it = int(need(i, a))
        elif a == "-ksp_gmres_restart":
            i += 1; ksp.restart = int(need(i, a))
        elif a == "-geneo_lvl":
            i += 1
            parts = need(i, a).split(",")
            if len(parts) != 2:
                raise CLIError("Error: invalid option -geneo_lvl")
            gen.lvl1, gen.lvl2 = parts
        elif a == "-geneo_optim":
            i += 1; gen.optim = float(need(i, a))
        elif a == "-geneo_tau":
            i += 1; gen.tau = float(need(i, a))
        elif a == "-geneo_gamma":
            i += 1; gen.gamma = float(need(i, a))
        elif a == "-geneo_cst":
            gen.cst = True
        elif a == "-geneo_cut":
            i += 1; gen.cut = int(need(i, a))
        elif a == "-geneo_no_syl":
            gen.no_syl = True
        elif a == "-geneo_offload":
            gen.offload = True
        # --- sub-solver option prefixes (dls1_/els2_/syl2_/dcs2_/ubl2_:
        # the reference's per-sub-solver namespacing, usageGenEO
        # geneo.cpp:2292-2299) ---
        elif a == "-dls1_type":
            i += 1; gen.dls1.type = need(i, a)
        elif a == "-els2_type" or a == "-els2_eps_type":
            i += 1
            v = need(i, a)
            gen.els2.type = {"arpack": "eigh", "krylovschur": "lobpcg",
                             "lapack": "eigh"}.get(v, v)
        elif a == "-els2_eps_max_it":
            i += 1; gen.els2.max_it = int(need(i, a))
        elif a == "-els2_eps_tol":
            i += 1; gen.els2.rtol = float(need(i, a))
        elif a.startswith(("-dls1_", "-syl2_", "-els2_", "-dcs2_",
                           "-ubl2_", "-chks_", "-chkr_",
                           "-Amat_", "-Avec_", "-Bmat_", "-Bvec_")):
            # accepted-and-consumed: tuning knobs of the reference's
            # solver backends (mumps/superlu/...) have no equivalent here
            # ('-A'/'-B' are the reference's Mat/Vec object prefixes,
            # geneo4PETSc.cpp:1309/1319).  Consume the value token if one
            # follows — including negative numbers, which start with '-'
            # but parse as floats.
            if i + 1 < len(argv):
                nxt = argv[i + 1]
                is_value = not nxt.startswith("-")
                if not is_value:
                    try:
                        float(nxt)
                        is_value = True
                    except ValueError:
                        pass
                if is_value:
                    i += 1
        elif a == "-geneo_dbg":
            i += 1
            parts = need(i, a).split(",")
            if len(parts) != 2:
                raise CLIError("Error: invalid option -geneo_dbg")
            dbg_fmt = parts[0]
            if dbg_fmt not in ("log", "bin", "mat"):
                raise CLIError("Error: invalid option -geneo_dbg")
            dbg_level = int(parts[1])
        elif a == "-geneo_chk":
            i += 1; need(i, a)
            check = True
        elif a == "-options_left":
            # PETSc accepts both bare '-options_left' and '-options_left no'
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1

        i += 1

    if pc_type is None:
        pc_type = "bjacobi"  # PETSc parallel default PC
    if pc_type not in ("geneo", "bjacobi", "mg", "none"):
        raise CLIError(f"Error: invalid option -pc_type {pc_type}")
    if not drv.inp_file_a and not drv.inp_lib_a:
        raise CLIError("Error: no input")
    if drv.inp_file_a and drv.inp_lib_a:
        raise CLIError("Error: several input")
    return drv, ksp, gen, pc_type, check, dbg_level, dbg_fmt, user_cmd


def run(argv: list[str], out=sys.stdout) -> int:
    t_total = time.perf_counter()
    try:
        drv, ksp, gen, pc_type, check, dbg_level, dbg_fmt, user_cmd = \
            parse_args(argv)
    except CLIError as e:
        if str(e) == "__help__":
            print(USAGE, file=sys.stderr)
            return 0
        print(str(e), file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1
    device = torch.device(drv.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run on the host)")
    from .parallel import multiproc
    if multiproc.init_from_env(device) and _rank() == 0:
        print(f"INFO: distributed: {multiproc.process_summary()}",
              file=sys.stderr)
    if drv.n_devices == "auto":
        drv.n_devices = _auto_devices(device)
    if drv.n_devices is not None and not drv.structured \
            and pc_type != "geneo":
        print(f"WRNG: --nbDevices ignored for -pc_type {pc_type} "
              "(multi-device runs the geneo PC)", file=out)
        drv.n_devices = None
    if drv.structured:
        return _run_structured(drv, ksp, gen, pc_type, out, t_total, device,
                               user_cmd, argv)
    if drv.n_devices is not None and not _in_group():
        return _launch(argv, drv, device, out)
    if _rank() != 0:
        out = io.StringIO()          # only rank 0 prints

    if gen.offload:
        # surfaced on stderr (stdout is the golden-diffed protocol): the
        # reference gathers Z and E to rank 0 and solves serially there
        # (src/geneo.cpp:288-319, :1435-1526); here the tiny coarse
        # factorization lives next to the batch on the device.  Numerics
        # and output (PC names, dims) are identical either way.
        print("INFO: -geneo_offload maps to a replicated coarse solve "
              "(the coarse factorization lives on the solve's device)",
              file=sys.stderr)

    from .assembly.assemble import assemble
    from .partition.decompose import partition_and_decompose
    from .solver import build_rhs, solve_assembled
    from .utils.check import CheckError, run_checks

    timers = Timers()

    # --- read input (L1) ---
    t0 = time.perf_counter()
    if drv.inp_file_a:
        mesh = ei.read_input_file(drv.inp_file_a, drv.inp_eps)
    else:
        mesh = get_lib_input(drv.inp_lib_a, drv.inp_lib_arg)
    timers.add("read_input", time.perf_counter() - t0)

    # --- partition & decompose (L2) ---
    t0 = time.perf_counter()
    decomp = partition_and_decompose(mesh, drv.n_parts,
                                     metis_dual=drv.metis_dual,
                                     add_overlap=drv.add_overlap)
    timers.add("part_decomp", time.perf_counter() - t0)
    for p in range(decomp.n_dom):
        if len(decomp.dom_nodes[p]) == 0:
            print(f"WRNG: the domain {p} is empty", file=out)

    # --- assemble (L3) ---
    t0 = time.perf_counter()
    ap = assemble(mesh, decomp, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timers.add("create_a", time.perf_counter() - t0)

    if drv.verbose >= 2:
        _dump_a(ap, drv, out)

    b = build_rhs(ap, drv)
    if drv.verbose >= 2:
        print(pf.format_vec(b, drv.n_parts, "B"), file=out)

    writer = _rank() == 0       # one rank writes the debug files
    if drv.debug and writer:
        _debug_driver_files(ap, b, drv)

    # --- solve (L4/L5) ---
    res = solve_assembled(ap, pc_type=pc_type, geneo=gen, ksp=ksp, b=b,
                          driver=drv, timers=timers,
                          n_devices=drv.n_devices)

    if check:
        try:
            run_checks(ap, res.pc, pc_type, stats=res.stats,
                       eps_tol=gen.els2.rtol)
        except CheckError as e:
            # the reference SETERRABORTs after dumping state; the CLI
            # analogue is a printed error and a nonzero exit
            print(f"ERROR: {e}", file=sys.stderr)
            return 2

    if dbg_level >= 1 and pc_type == "geneo" and writer:
        from .utils import debug as dbg
        dbg.dump_timing(timers)
        if dbg_level >= 2:
            dbg.dump_setup(res.pc, res.stats, decomp=decomp, fmt=dbg_fmt,
                           tau=gen.tau)
            # one apply on B stands in for the per-apply dumps
            dbg.dump_apply(res.pc, b, fmt=dbg_fmt)

    if drv.verbose >= 1:
        print(pf.format_vec(res.x, drv.n_parts, "X").replace(
            "The vector X is:", "The solution X is:"), file=out)

    if drv.debug and writer:
        if drv.debug_bin:
            # PetscViewerBinary (VecLoad-compatible), --debug bin
            pf.write_vec_bin("debug.output.X.bin", res.x)
        np.savetxt("debug.output.X.log", res.x, fmt="%.12g")
        h = res.result.history.numpy()
        h = h[~np.isnan(h)]
        with open("debug.apply.residual.log", "w") as f:
            for it, r in enumerate(h):
                f.write(f"Iteration {it}: residual {r:g}\n")

    _print_info(res, drv, ksp, gen, pc_type, out)
    _print_results(res, drv, out)
    if drv.timing:
        _print_timing(res, drv, gen, pc_type, timers, out,
                      time.perf_counter() - t_total)
    if drv.cmd_line:
        print(f"\nCMD: {user_cmd}", file=out)
    return 0  # the reference returns 0 either way; the result is in the log


def _run_structured(drv, ksp, gen, pc_type, out, t_total, device,
                    user_cmd, argv) -> int:
    """--structured GX,GY,GZ: drive the structured scale backends
    (structured/) with the standard INFO/TIME protocol.

    Tensor-grid generators: laplacian (separable kappa -> exact FDM local
    solves), heat (mass term -> block-tridiagonal or inexact local
    solvers, structured/solvers.py) and elasticity (the 3-D Q1 vector
    backend, structured/elastic.py: inexact local solves under flexible
    CG, float32 inside float64 refinement on a card, float64 on the
    CPU)."""
    from .models import _grid
    from .structured.grid import heat_grid, laplacian_grid
    from .structured.solve import solve_structured

    if pc_type != "geneo" or drv.inp_lib_a not in ("laplacian", "heat",
                                                   "elasticity"):
        print("Error: --structured requires --inpLibA "
              "laplacian|heat|elasticity and -pc_type geneo",
              file=sys.stderr)
        return 1
    try:
        dom_grid = tuple(int(t) for t in drv.structured.split(","))
        if len(dom_grid) != 3:
            raise ValueError
    except ValueError:
        print("Error: invalid option --structured (want GX,GY,GZ)",
              file=sys.stderr)
        return 1

    opt = _grid.parse_args(drv.inp_lib_arg.replace("#", " "), {
        "size": int, "weakScaling": int, "dim": int, "inpEps": float,
        "kappa": tuple, "lbd": float, "dt": float, "nu": float,
        "spring": float, "verbose": bool, "debug": bool,
    })
    kappa_max, interp = opt.get("kappa", (1.0, ""))
    overlap = max(drv.add_overlap, 1)
    timers = Timers()
    if drv.n_devices is not None and not _in_group():
        # refuse a mesh the ranks cannot split before launching them
        from .structured.sharded import need_divisible
        if drv.inp_lib_a == "elasticity":
            nz = opt.get("size", 4)
        else:
            dim = opt.get("dim", 3)
            nz = _grid.grid_size(opt.get("size", 4),
                                 opt.get("weakScaling", 1), dim) \
                if dim >= 3 else 1
        try:
            need_divisible(nz, int(np.prod(dom_grid)), drv.n_devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        return _launch(argv, drv, device, out)
    if _rank() != 0:
        out = io.StringIO()          # only rank 0 prints
    if drv.inp_lib_a == "elasticity":
        if ksp.type != "cg":
            print("Error: --structured elasticity supports -ksp_type cg",
                  file=sys.stderr)
            return 1
        from .structured.elastic import elastic_grid, solve_elastic
        grid = elastic_grid(opt.get("size", 4), kappa_max=kappa_max,
                            interp=interp, nu=opt.get("nu", 0.3),
                            spring=opt.get("spring", 1.0))
        try:
            res = solve_elastic(grid, dom_grid, overlap, opts=gen,
                                tol=ksp.rtol, timers=timers, device=device,
                                checkpoint_dir=_checkpoint_dir(),
                                n_devices=drv.n_devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        nx, ny, nz = grid.shape
        n_elems = (nx - 1) * (ny - 1) * (nz - 1) + 3 * nx * ny
        nnz = 9 * (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
        n_dof_line = grid.n_dof
    else:
        kw = dict(dim=opt.get("dim", 3), kappa_max=kappa_max,
                  interp=interp, inp_eps=opt.get("inpEps", drv.inp_eps),
                  weak_scaling=opt.get("weakScaling", 1))
        if drv.inp_lib_a == "heat":
            grid = heat_grid(opt.get("size", 4), lbd=opt.get("lbd", 1.0),
                             dt=opt.get("dt", 0.1), **kw)
        else:
            grid = laplacian_grid(opt.get("size", 4), **kw)
        try:
            res = solve_structured(grid, dom_grid, overlap, geneo=gen,
                                   ksp=ksp, tol=ksp.rtol, timers=timers,
                                   device=device,
                                   checkpoint_dir=_checkpoint_dir(),
                                   n_devices=drv.n_devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        n_edges = sum((grid.shape[a] - 1)
                      * (grid.n_nodes // max(grid.shape[a], 1))
                      for a in range(grid.dim))
        n_elems = n_edges + grid.n_nodes // grid.shape[grid.dim - 1]
        nnz = grid.n_nodes + 2 * n_edges
        n_dof_line = grid.n_nodes

    mode = f"structured {dom_grid[0]}x{dom_grid[1]}x{dom_grid[2]}"
    if drv.n_devices is not None:
        mode += f", nb devices {drv.n_devices}"
    print(f"INFO: nb DOFs {n_dof_line}, nb elements {n_elems}, "
          f"nnz coefs {nnz}, nb partitions {res.n_dom}, overlap {overlap}, "
          f"{mode}", file=out)
    print(f"INFO: {ksp.type} ksp, eps rel {ksp.rtol:.1e}, "
          f"eps abs {ksp.atol:.1e}, max iterations {ksp.max_it}", file=out)
    l1_kind = {"FDMFactor": "fdm", "BTSolver": "block-tridiag",
               "PCGSolver": "inexact-pcg"}[type(res.pc.l1).__name__]
    line = f"INFO: {gen.name} pc, L1 {l1_kind}"
    if gen.lvl2_num:
        line += f", tau {gen.tau:.2f}, L2 {gen.els2.type} shift-invert"
        if gen.lvl2_num == 2:
            line += f", gamma {gen.gamma:.2f}"
    print(line, file=out)
    if not drv.short_res:
        st = res.stats
        print(f"INFO: setup - estim dimE {st.estim_dim_e.sum()} (local: "
              f"min {st.estim_dim_e.min()}, max {st.estim_dim_e.max()}), "
              f", real dimE {st.real_dim_e.sum()} (local: "
              f"min {st.real_dim_e.min()}, max {st.real_dim_e.max()})"
              f", nicolaides {st.nicolaides.sum()}", file=out)
    status = "converged" if res.converged else "diverged"
    if drv.short_res:
        print(f"INFO: solve - {status}", file=out)
    else:
        print(f"INFO: solve - {status} (refined, "
              f"{res.refined.outer_its} outer), "
              f"{res.refined.inner_its} iteration(s), "
              f"|| AX - B || / || B || {res.true_res:.10f}", file=out)
    if drv.verbose >= 1:
        print(pf.format_vec(res.x, res.n_dom, "X").replace(
            "The vector X is:", "The solution X is:"), file=out)
    if drv.timing:
        t = timers.get
        print("", file=out)
        print(f"TIME: read input 0.00000 s, part / decomp "
              f"{t('partition'):.5f} s, create A {t('createA'):.5f} s, "
              f"solver set up {t('setup'):.5f} s, solver iterations "
              f"{t('solve'):.5f} s, solve "
              f"{t('setup') + t('solve'):.5f} s", file=out)
        print(f"      L1       setup: Minv {t('l1_minv'):.5f} s", file=out)
        if gen.lvl2_num:
            print(f"      L2       setup: eigen solve {t('l2_eig'):.5f} s"
                  f", Z {t('l2_z'):.5f} s, E {t('l2_e'):.5f} s", file=out)
        print(f"TIME: total {time.perf_counter() - t_total:.5f} s",
              file=out)
    if drv.cmd_line:
        print(f"\nCMD: {user_cmd}", file=out)
    return 0  # the reference returns 0 either way; the result is in the log


def _debug_driver_files(ap, b, drv):
    mask = ap.batch.mask.cpu().numpy()
    aneu = ap.batch.a_neu.cpu().numpy().astype(np.float64, copy=False)
    with open("debug.input.A.MatIS.log", "w") as f:
        blocks = [aneu[p, :int(mask[p].sum()), :int(mask[p].sum())]
                  for p in range(ap.batch.n_dom)]
        f.write(pf.format_matis(blocks, drv.n_parts))
    if drv.debug_mat:
        # Matlab export (--debug mat; PETSC_VIEWER_ASCII_MATLAB role)
        with open("debug.input.A.mat", "w") as f:
            f.write(pf.format_mat_matlab(ap.a_csr.toarray(), "A"))
        with open("debug.input.B.mat", "w") as f:
            f.write(pf.format_vec_matlab(b, "B"))
    if drv.debug_bin:
        # PetscViewerBinary (MatLoad/VecLoad-compatible), --debug bin
        pf.write_mat_bin("debug.input.A.bin", ap.a_csr)
        pf.write_vec_bin("debug.input.B.bin", b)
    np.savetxt("debug.input.B.log", b, fmt="%.12g")


def _checkpoint_dir() -> str | None:
    """The structured paths' setup cache (GENEO_CHECKPOINT_DIR, the JAX
    package's switch for it); None when unset."""
    import os
    return os.environ.get("GENEO_CHECKPOINT_DIR") or None


def _dump_a(ap, drv, out):
    if drv.use_mat_mpi:
        print(pf.format_aij_global(ap.a_csr.toarray(), drv.n_parts, "A"),
              file=out)
    else:
        mask = ap.batch.mask.cpu().numpy()
        aneu = ap.batch.a_neu.cpu().numpy().astype(np.float64, copy=False)
        blocks = []
        for p in range(ap.batch.n_dom):
            k = int(mask[p].sum())
            blocks.append(aneu[p, :k, :k])
        print(pf.format_matis(blocks, drv.n_parts, "A"), file=out)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_initialized()


def _auto_devices(device) -> int:
    """--nbDevices auto: the group's size, else every card of a cuda run
    (one rank on the CPU)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _launch(argv, drv, device, out) -> int:
    """The one-command launch: D local ranks, each running this CLI;
    rank 0's output is the run's."""
    from .parallel import multiproc
    try:
        multiproc.check_cards(drv.n_devices, device)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    rc, text = multiproc.run_ranks(_rank_run, drv.n_devices, args=(argv,),
                                   device=device)
    out.write(text)
    return rc


def _rank_run(argv):
    """One launched rank of the CLI: its return code and what it printed
    (rank 0's is the run's output)."""
    buf = io.StringIO()
    rc = run(argv, out=buf)
    return rc, buf.getvalue()


def _print_info(res, drv, ksp, gen, pc_type, out):
    mode = "metis dual" if drv.metis_dual else "metis nodal"
    if drv.n_devices is not None and pc_type == "geneo":
        mode += f", nb devices {drv.n_devices}"
    print(f"INFO: nb DOFs {res.n_dof}, nb elements {res.n_elems}, "
          f"nnz coefs {res.nnz}, nb partitions {res.n_dom}, "
          f"overlap {drv.add_overlap}, {mode}", file=out)
    print(f"INFO: {ksp.type} ksp, eps rel {ksp.rtol:.1e}, "
          f"eps abs {ksp.atol:.1e}, max iterations {ksp.max_it}", file=out)
    if pc_type == "geneo":
        line = f"INFO: {gen.name} pc"
        if gen.lvl1_oras:
            line += f", optim {gen.optim:.2f}"
        if gen.eff_hybrid:
            line += ", initial guess"
        l1_solver = gen.dls1.type
        proj = "proj-fine-space" if gen.hybrid else "no-proj-fine-space"
        line += f", L1 {l1_solver} {proj}"
        if gen.lvl2_num:
            line += f", tau {gen.tau:.2f}"
            if gen.lvl2_num >= 2:
                line += f", gamma {gen.gamma:.2f}"
            if gen.offload:
                line += ", offload"
            line += f", L2 {res.info_l2}"
            print(line, file=out)
            if not drv.short_res:
                st = res.stats
                line = "INFO: setup - "
                if not gen.no_syl:
                    line += (f"estim dimE {st.estim_dim_e.sum()} (local: "
                             f"min {st.estim_dim_e.min()}, "
                             f"max {st.estim_dim_e.max()}), ")
                line += (f", real dimE {st.real_dim_e.sum()} (local: "
                         f"min {st.real_dim_e.min()}, "
                         f"max {st.real_dim_e.max()})"
                         f", nicolaides {st.nicolaides.sum()}")
                print(line, file=out)
                if st.e_null:
                    # rank-deficient coarse operator: the spectral
                    # pseudo-inverse fixed e_null null pivots (MUMPS
                    # ICNTL(24) role); the PC is singular on those
                    # directions and the default preconditioned norm
                    # cannot see them — check the true residual
                    print(f"WRNG: E is rank-deficient, {st.e_null} null "
                          "pivots fixed (check the true residual)",
                          file=out)
                if st.lobpcg_res is not None \
                        and float(st.lobpcg_res.max(initial=0.0)) \
                        > gen.els2.rtol:
                    # kept eigenpairs above the reference's EPS tolerance
                    # analogue (checkEPSSolve, geneo.cpp:577-624): the
                    # coarse space is degraded, CG may need extra its
                    print("WRNG: eigensolver residual "
                          f"{float(st.lobpcg_res.max()):.3e} above "
                          f"tolerance {gen.els2.rtol:g} on "
                          f"{int((st.lobpcg_res > gen.els2.rtol).sum())} "
                          "domain(s)", file=out)
        else:
            print(line, file=out)
            if not drv.short_res:
                print("INFO: setup - none", file=out)
    else:
        print(f"INFO: {pc_type} pc", file=out)
        if not drv.short_res:
            print("INFO: setup - none", file=out)


def _print_results(res, drv, out):
    status = "converged" if res.converged else "diverged"
    if drv.short_res:
        print(f"INFO: solve - {status}", file=out)
        return
    reason = kcm.reason_string(res.result.reason)
    print(f"INFO: solve - {status} ({reason}), {res.its} iteration(s), "
          f"residual norm {res.result.rnorm:.10f}, "
          f"|| AX - B || / || B || {res.true_res:.10f}", file=out)


def _print_timing(res, drv, gen, pc_type, timers: Timers, out, total_s):
    t = timers.get
    print("", file=out)
    print(f"TIME: read input {t('read_input'):.5f} s, "
          f"part / decomp {t('part_decomp'):.5f} s"
          f", create A {t('create_a'):.5f} s, "
          f"solver set up {t('ksp_setup'):.5f} s"
          f", solver iterations {t('ksp_iterations'):.5f} s, "
          f"solve {t('ksp_iterations') + t('ksp_setup'):.5f} s", file=out)
    if pc_type == "geneo":
        print(f"      L1       setup: Minv {t('l1_minv'):.5f} s", file=out)
        if gen.lvl2_num:
            line = "      L2       setup: "
            if not gen.no_syl:
                line += f"sylvester {t('l2_syl'):.5f} s, "
            line += (f"eigen solve {t('l2_eig'):.5f} s, Z {t('l2_z'):.5f} s"
                     f", E {t('l2_e'):.5f} s")
            print(line, file=out)
            line = f"      L2 tau   setup: tau   loc {t('l2_tau_loc'):.5f} s"
            if not gen.no_syl:
                line += f", sylvester {t('l2_tau_syl'):.5f} s"
            line += f", eigen solve {t('l2_tau_eig'):.5f} s"
            print(line, file=out)
            if gen.lvl2_num >= 2:
                line = ("      L2 gamma setup: gamma loc "
                        f"{t('l2_gamma_loc'):.5f} s")
                if not gen.no_syl:
                    line += f", sylvester {t('l2_gamma_syl'):.5f} s"
                line += f", eigen solve {t('l2_gamma_eig'):.5f} s"
                print(line, file=out)
        print(f"      L1       solve: apply {t('l1_apply'):.5f} s - "
              f"scatter {t('l1_scatter'):.5f} s, Minv {t('l1_minv_apply'):.5f} s, "
              f"gather {t('l1_gather'):.5f} s", file=out)
        if gen.hybrid:
            print(f"      L1       solve: prjFS {t('prjfs'):.5f} s - "
                  f"Zt {t('prjfs_zt'):.5f} s, Einv {t('prjfs_einv'):.5f} s, "
                  f"Z {t('prjfs_z'):.5f} s", file=out)
        if gen.lvl2_num:
            print(f"      L2       solve: apply {t('l2_apply'):.5f} s - "
                  f"Zt {t('l2_zt'):.5f} s, Einv {t('l2_einv'):.5f} s, "
                  f"Z {t('l2_z_apply'):.5f} s", file=out)
    print(f"TIME: total time {total_s:.5f} s", file=out)


def main() -> int:
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
