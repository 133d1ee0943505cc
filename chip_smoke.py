"""Drive the PyTorch port (geneo4petsc_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure ends the script
with a non-zero exit code and no result line:

1. device   — the card's name and power limit (nvidia-smi), its row of
              the peaks table (utils/roofline.py); TF32 off.
2. build    — compile the CUDA kernels of geneo4petsc_tpu_torch/csrc/
              (nvcc, sm_90a) and the native partitioner (native/kway.cpp).
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the main paths' shapes ([1024, 496, 496] float64 of the
              slice, [1024, 320, 320] float32 of large, [64, 448, 448]
              float64 of generic-family's lobpcg cases) and at shapes
              that reach both of its paths (the bulk-copy ring and the
              direct loads) and their edges: odd n, n no multiple of 32,
              fewer domains than SMs, a domain count no multiple of the
              grid, a large n, float32 with n % 4 of 0 and 2, and a batch
              whose base pointer is 8- but not 16-byte aligned; max
              relative error <= 1e-12 (float64) / 1e-5 (float32), and
              repeated launches give the same bits.
4. small    — the same small GenEO solve through the CLI on cpu and on
              cuda: equal iteration counts and reasons.
5. slice    — the generic GenEO path at 262,144 DOF through the CLI
              (laplacian --size 512 --dim 2 --kappa 10000. minmax, 1024
              subdomains, overlap 1, ASM,E1, inverse_pallas, CG 1e-8);
              checks convergence, dim_e, Nicolaides count, iterations
              and that the main path launched both kernels.
6. structured-parity — the structured path (solve_structured) in float64
              on laplacian 24^3, kappa 1e4 minmax, 2x2x2 boxes, overlap 2,
              ASM,E1, LOBPCG cut 2, CG 1e-8, by both refinement routes:
              per-domain dim_e and Nicolaides, outer passes and inner
              iterations (+-1) equal to the JAX package's on the CPU,
              true residual <= 1e-8.
7. structured — the structured path through the CLI at the repository's
              10,077,696-DOF case (laplacian --size 216 --dim 3 --kappa
              10000. minmax, --structured 4,4,4, overlap 2, ASM,E1, LOBPCG
              cut 2 max_it 50, float32 CG inside float64 refinement to
              1e-8): converged, true residual <= 1e-8 (and again on the
              host), max error against x = 1..n, dim_e, iterations, TIME
              lines and peak device memory, beside the JAX package's TPU
              record as a reference.  K1 and K2 are not on this path:
              their counts, zeroed before it, stay 0.
8. large    — the JAX package's `bench.py large` configuration through
              the port's library, at full width: laplacian --size 512
              --dim 2 --kappa 10000. minmax (262,144 DOF), the brick
              partition into 32x32 = 1024 domains, the nodal fast
              decomposition, float32 assembly, ASM,E1 with block inverses
              (K1) and the LOBPCG eigensolve on the card (cut 4, 50
              iterations), the float32 PC inner CG (K2 in every
              iteration) inside float64 refinement to a true 1e-8 (at
              most 14 outer passes).  Checks convergence, the true
              residual again on the host in float64, dim_e <= 4 per
              domain + Nicolaides, that the pencils and LOBPCG ran on the
              card, and the K1/K2 launches against the inner iterations;
              prints the JAX bench's phases beside the slice's host-eigh
              numbers (a reference, not a check).
9. generic-family — the modules of the generic path beyond laplacian +
              GenEO through the CLI, each case on cpu and on cuda in this
              process (float64): a heat and a graph golden entry (dual
              GenEO-1, nodal SORAS GenEO-2), bjacobi (ILU(0)) on a
              laplacian golden entry, -pc_type mg with a W cycle and 5/5
              sweeps, and -els2_type lobpcg with no cut (ASM,E1 under CG
              and SORAS,E2 under GMRES: Sylvester inertia by LDL^T on the
              card) on laplacian --size 128, 64 domains; equal iterations, reasons,
              dim_e, Nicolaides and per-domain inertia estimates on both
              devices, and the golden counts where there are some.  Times
              the inertia route (LDL^T) at the lobpcg cases' shape, and
              checks its counts there against the host's.
10. path-shapes — each kernel at every shape a main path (slice, large,
              generic-family) launched it at, as that path's batch gave
              it: held against its plain version as in phase 3, then
              timed in turns with torch.bmm (the library call for the
              same product, which the port never calls on the card) and
              with its plain version by CUDA events, beside its bound
              from the bytes and operations (roofline.bound_ms).

11. api     — the library entry point (api.make_batch, geneo_setup,
              geneo_solve: the PCGenEOSetup twin) on the JAX package's
              tests/test_api.py case, a hand-built two-domain 1-D Poisson
              problem, with -dls1_type inverse_pallas (K1) under CG and
              SORAS,2 with intersections under GMRES, on cpu and cuda:
              equal iterations and reasons, x = 1..n; counts the K1/K2
              launches of the cuda runs.
12. chk-dbg — the CLI on laplacian 6x6 with -geneo_chk and -geneo_dbg
              log,2, and with --debug bin, on cpu and cuda in two scratch
              directories: the same file set, each PETSc binary reads
              back (A x = b on the binary dumps, X binary = X text).
13. elastic-parity — the elastic backend (solve_elastic, float64, host
              refinement route) at size 6, kappa 1e3 minmax, 2x2x1 boxes,
              overlap 1: ASM,1 and SORAS,2 on the dense route, ASM,E1 on
              the LOBPCG route from the JAX package's start block (its
              float64 draw rebuilt without JAX); raw and real dim_e,
              Nicolaides, pruned columns, outer and inner iterations on
              the card equal to the JAX package's on the CPU (constants
              below) and to the port's own cpu run; true residual <= 1e-8.
14. elastic — the 10,535,424-DOF Q1 elasticity case of the JAX package's
              bench (bench.py:491-545): elastic_grid(152, kappa_max=1e4,
              interp="minmax", spring=1e4), 4x4x4 boxes, overlap 2,
              ASM,E1 with LOBPCG (60 iterations, cut 8), level-1 PCG rtol
              0.05 at most 40 iterations, float32 flexible CG inside
              float64 refinement to a true 1e-8 (the setup and the global
              operator in float64: in float32 the case does not
              converge, PERF.md).  Nothing is cut.  Prints
              dim_e, Nicolaides, inner/outer iterations, the true
              residual (and again on the host), max |x - x_true| / n, the
              phase seconds and the peak device memory; passes only if it
              converges to <= 1e-8.  K1 and K2 are not on this path.

15. block-layout — the 10M case of phase 7 through solve_structured in
              the global and in the block layout (block_layout=True,
              structured/blockmode.py): dim_e equal, outer passes within
              1, true residual <= 1e-8 (the JAX package's
              tests/test_blockmode.py contracts); TIME: total and the
              mean inner iteration by CUDA events of both.
16. nccl-structured — the same 10M case with n_devices=1: one spawned
              rank in a world-size-1 NCCL group (z-slab plane plan,
              plane exchanges, all_reduce inner products); counts equal
              to phase 15's global layout, true residual <= 1e-8, the
              time of an inner iteration beside it.
17. nccl-generic — the JAX package's three GENERIC_CONFIGS
              (tests/test_cli_multidevice.py) and one -dls1_type
              inverse_pallas case through the CLI with --nbDevices 1 on
              cuda, in a world-size-1 NCCL group of this process:
              iterations equal to the CLI without --nbDevices; K1/K2
              launched on the rank's chunk (counted, and the chunk shapes
              go to phase path-shapes).
18. nccl-elastic — elastic-parity's ASM,1 case with n_devices=1 (one
              spawned NCCL rank): counts equal to the JAX constants.
19. multi-rank-cpu — gloo ranks on the host CPU through the CLI: the
              GENERIC_CONFIGS on 4, 8, 4 ranks and the elastic case on 8
              equal to the JAX package's --nbDevices counts (constants
              below); the STRUCTURED_CONFIGS on 8, 4, 2 ranks within
              MULTI_FLOOR_BAND of them (dim_e equal, outer passes within
              1), and again with a float64 inner CG through the library,
              equal to JAX's float64 counts (MULTI_FLOAT64);
              true residuals <= 1e-8.
20. roofline — right after phase 15, on its two solves:
              roofline.measure_structured on the global layout's
              preconditioner and on the block layout's (blk=), with the
              tau pencil of the setup (one LOBPCG step), each solve's
              solve seconds and inner iterations, and a 60 s budget;
              prints the card's line and one JSON line per layout.  Fails
              when the card has no row in the peaks table, when an entry
              was skipped, or when a share of a peak reads over 1.05.
              Then checks that geneo4petsc_tpu_torch/perf/
              coarse_scaling.json (the coarse replication wall) is there,
              names an NVIDIA card and gives the wall the package reads.

21. battery — the JAX package's on-chip battery (tst/smoke_tpu.py)
              through the port on the card in float64, from the JAX
              package's LOBPCG start block, 2x2x2 boxes, overlap 1: on
              laplacian 24^3 (kappa 1e4 minmax) ORAS,0, SORAS,2,
              SORAS,H2 and ASM,E1, and ASM,E1 with n_devices=1 (one
              spawned NCCL rank); heat 16^3 SORAS,2; the non-separable
              inclusion grid 24^3 ASM,E1 (level-1 PCG rtol 0.05, 40
              iterations) on the exact block-tridiagonal route and, with
              bt_budget_bytes=0, on the inexact surrogate-PCG route;
              elasticity size 10 RAS,1 and SORAS,2 (tau 0.3, cut 8,
              level-1 PCG 0.02 / 80).  Each case converged to <= 1e-8,
              with the JAX package's float64 outer passes and per-domain
              dim_e (GenEO-2: the pre-prune counts and the total), inner
              iterations within 1 on an exact route and within
              BATTERY_INEXACT_BAND on an inexact one (BATTERY_JAX), the
              level-1 solver of its route, finite on the card, and Z on
              the card; no K1/K2 launch.  The TPU's record
              (tst/golden/smoke_tpu_results.json) is printed beside
              each case, not held.
22. nonsep  — the JAX package's `bench.py nonsep10m` (bench.py:403-488):
              inclusion_grid(216, dim=3, kappa_max=1e4, n_inc=27),
              10,077,696 DOF, 4x4x4 boxes, overlap 2, ASM,E1, LOBPCG cut
              2 max_it 50, level-1 PCG rtol 0.05 at most 40 iterations,
              on the card's default plan (float32 inner CG in float64
              refinement to a true 1e-8), once.  The factor of the exact
              route would take ~168 GB, so the level-1 solves and the
              shift-invert LOBPCG run the surrogate-FDM PCG.  Holds
              convergence (and again on the host), the inexact route and
              no K1/K2 launch; prints the counts, dim_e, rel_err_max
              against x = 1..n, the phase seconds, peak memory, the PCG
              iterations of the LOBPCG and of each level-1 apply, and one
              level-1 apply timed with and without its per-iteration
              host check (CUDA events, in turns).

Phase battery runs after phase 6 and nonsep after phase 7; phase
path-shapes runs last, over the shapes of phases 5, 8, 9, 11, 12 and
17.

It then prints its wall seconds, one JSON line with every kernel's
launches (the sum over the phases that drive a main path, and each
phase's count), and its error, path, times and bound at the slice's
shape and, under "shapes", at every shape of phase 10; and last the
result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import io
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE_ARGS = ["--inpLibA", "laplacian",
              "--inpLibArg", "--size#512#--dim#2#--kappa#10000.#minmax",
              "--nbPart", "1024", "--addOverlap", "1", "--metisDual",
              "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
              "-dls1_type", "inverse_pallas", "-ksp_type", "cg",
              "-ksp_rtol", "1e-8"]
SLICE_DOF, SLICE_DIM_E, SLICE_NICOLAIDES, SLICE_ITS = 262144, 2776, 1, 58
SMALL_ARGS = ["--inpLibA", "laplacian", "--inpLibArg", "--size#32#--dim#2",
              "--nbPart", "8", "--addOverlap", "1", "-pc_type", "geneo",
              "-geneo_lvl", "ASM,E1", "-dls1_type", "inverse_pallas",
              "-ksp_type", "cg", "-ksp_rtol", "1e-8"]
MAIN_SHAPE = (1024, 496)   # (n_dom, n_max) of the slice
TOL = {"float64": 1e-12, "float32": 1e-5}
# (n_dom, n), dtype, base pointer 16-byte aligned, the path it must take
KERNEL_CASES = [
    (MAIN_SHAPE, "float64", True, "ring"),
    ((3, 37), "float64", True, "direct"),       # odd n
    ((3, 37), "float32", True, "direct"),
    ((7, 50), "float64", True, "ring"),         # n % 32 != 0, few domains
    ((5, 66), "float32", True, "direct"),       # n % 4 == 2
    ((5, 64), "float32", True, "ring"),         # n % 4 == 0
    ((133, 496), "float64", True, "ring"),      # n_dom % grid != 0
    ((2, 3000), "float64", True, "ring"),       # large n
    ((7, 50), "float64", False, "direct"),      # misaligned base pointer
    (MAIN_SHAPE, "float64", False, "direct"),
    ((1024, 320), "float32", True, "ring"),     # large's shape
    ((64, 448), "float64", True, "ring"),       # generic-family's lobpcg
]

# structured-parity: the JAX package's values on the CPU (float64), from
#   python -c "import jax; jax.config.update('jax_enable_x64', True)
#   import jax.numpy as jnp
#   from geneo4petsc_tpu.config import GenEOOptions, KSPOptions
#   from geneo4petsc_tpu.structured.grid import laplacian_grid
#   from geneo4petsc_tpu.structured.solve import solve_structured
#   g = GenEOOptions(); g.lvl1, g.lvl2 = 'ASM', 'E1'
#   g.els2.type, g.els2.max_it, g.cut = 'lobpcg', 50, 2
#   for dr in (False, True):
#       o = solve_structured(laplacian_grid(24, dim=3, kappa_max=1e4,
#           interp='minmax'), (2, 2, 2), 2, geneo=g,
#           ksp=KSPOptions(type='cg'), tol=1e-8, dtype=jnp.float64,
#           device_refine=dr)
#       print(o.refined.outer_its, o.refined.inner_its,
#             list(o.stats.real_dim_e), list(o.stats.nicolaides), o.true_res)"
# run from the repository root with JAX on the CPU.
PARITY_GRID = dict(size=24, dim=3, kappa_max=1e4, interp="minmax")
PARITY_DOMS, PARITY_OVERLAP = (2, 2, 2), 2
PARITY_DIM_E, PARITY_NICOLAIDES = [1] * 8, [0] * 8
PARITY_JAX = {"host": {"outer": 2, "inner": 34, "true_res": 7.387e-11},
              "device": {"outer": 2, "inner": 29, "true_res": 2.357e-10}}
STRUCTURED_ARGS = ["--structured", "4,4,4", "--inpLibA", "laplacian",
                   "--inpLibArg", "--size#216#--dim#3#--kappa#10000.#minmax",
                   "--addOverlap", "2", "-pc_type", "geneo",
                   "-geneo_lvl", "ASM,E1", "-els2_type", "lobpcg",
                   "-els2_eps_max_it", "50", "-geneo_cut", "2",
                   "-ksp_type", "cg", "-ksp_rtol", "1e-8", "--timing"]
STRUCTURED_DOF = 10077696
# the JAX package's record of this case on a TPU v5e (BENCH_r05.json):
# a reference point, not a target
JAX_TPU_RECORD = "dim_e 113, 140 inner / 3 outer iterations, true_res 1.33e-9"

# api: the JAX package's tests/test_api.py problem, x = 1..n
API_N, API_OVERLAP = 12, 2
# chk-dbg: one laplacian case with the check and level-2 dumps, one with
# the CLI's binary dumps
CHK_DBG_ARGS = {
    "chk+dbg": ["--inpLibA", "laplacian", "--inpLibArg", "--size#6#--dim#2",
                "--nbPart", "3", "-pc_type", "geneo", "-geneo_lvl", "RAS,1",
                "-geneo_chk", "log", "-geneo_dbg", "log,2"],
    "debug bin": ["--inpLibA", "laplacian", "--inpLibArg",
                  "--size#6#--dim#2", "--nbPart", "2", "-pc_type", "geneo",
                  "-geneo_lvl", "ASM,1", "--debug", "bin"],
}
# elastic-parity: the JAX package's values on the CPU (float64), from
#   python -c "import jax; jax.config.update('jax_enable_x64', True)
#   import jax.numpy as jnp
#   from geneo4petsc_tpu.config import GenEOOptions
#   from geneo4petsc_tpu.structured.elastic import elastic_grid, solve_elastic
#   for lvl, eig in (('ASM,1', 'eigh'), ('SORAS,2', 'eigh'),
#                    ('ASM,E1', 'lobpcg')):
#       o = GenEOOptions(); o.lvl1, o.lvl2 = lvl.split(','); o.els2.type = eig
#       o.dls1.rtol, o.dls1.max_it = 1e-11, 500
#       r = solve_elastic(elastic_grid(6, kappa_max=1e3, interp='minmax'),
#                         (2, 2, 1), 1, o, tol=1e-8, dtype=jnp.float64)
#       print(lvl, eig, r.refined.outer_its, r.refined.inner_its,
#             list(r.stats.raw_dim_e), list(r.stats.real_dim_e),
#             list(r.stats.nicolaides), r.stats.e_pruned, r.true_res)"
# run from the repository root with JAX on the CPU.
ELASTIC_PARITY_GRID = dict(size=6, kappa_max=1e3, interp="minmax")
ELASTIC_PARITY_DOMS, ELASTIC_PARITY_OVERLAP = (2, 2, 1), 1
ELASTIC_PARITY_JAX = {
    ("ASM,1", "eigh"): dict(outer=3, inner=17, raw_dim_e=[6] * 4,
                            real_dim_e=[6] * 4, nicolaides=[0] * 4,
                            e_pruned=0, true_res=3.105684778819506e-09),
    ("SORAS,2", "eigh"): dict(outer=2, inner=15, raw_dim_e=[72] * 4,
                              real_dim_e=[72] * 4, nicolaides=[0] * 4,
                              e_pruned=0, true_res=7.555447484969153e-09),
    ("ASM,E1", "lobpcg"): dict(outer=2, inner=10, raw_dim_e=[6] * 4,
                               real_dim_e=[6] * 4, nicolaides=[0] * 4,
                               e_pruned=0, true_res=6.1669219492459345e-09),
}
ELASTIC_SIZE, ELASTIC_DOMS, ELASTIC_OVERLAP = 152, (4, 4, 4), 2
ELASTIC_DOF = 10535424          # 3 * 152^3

# block-layout / nccl-structured: the 10,077,696-DOF case of phase 7
# through the library (its CLI arguments, as solve_structured options)
TEN_M_GRID = dict(size=216, dim=3, kappa_max=1e4, interp="minmax")
TEN_M_DOMS, TEN_M_OVERLAP = (4, 4, 4), 2
# roofline: the measurement's wall, and the most a share of a peak may
# read (above 1 the model left out work or the timing window ended early)
ROOFLINE_BUDGET_S, ROOFLINE_MAX_SHARE = 60.0, 1.05
# multi-rank-cpu: the JAX package's --nbDevices counts on the CPU
# (float64, 8 virtual devices), from its CLI with the arguments of
# tests/test_cli_multidevice.py:
#   XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "
#   import io, jax; jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_enable_x64', True)
#   from geneo4petsc_tpu import cli
#   b = io.StringIO(); cli.run(ARGS + ['--nbDevices', str(D)], out=b)
#   print(b.getvalue())"
# run from the repository root, one call per case below; (inner
# iterations, real dimE, outer passes; None on the generic path)
MULTI_GENERIC = [("ASM,1", 4, 21, 17), ("RAS,H1", 8, 11, 17),
                 ("SORAS,E2", 4, 8, 92)]
MULTI_STRUCTURED = [("laplacian", "ASM,E1", 8, 39, 8, 2),
                    ("laplacian", "RAS,1", 4, 36, 8, 2),
                    ("heat", "SORAS,2", 2, 16, 2368, 3)]
MULTI_ELASTIC = (8, 24, 48, 2)
# the structured cases' float32 inner CG ends its first outer pass at the
# float32 floor, where the pass's true residual (and so the next pass's
# tolerance) is set by rounding: the JAX package's own counts move across
# its device counts (RAS,1: 37, 38, 36, 43 inner on 1, 2, 4, 8), and the
# port's counts on the CPU were 38 / 34 / 16 inner against JAX's
# 39 / 36 / 16, and 3 outer passes against JAX's 2 for RAS,1
# (tests/_torch_roundoff_witness.py ranks).  This band was set after a
# run of this phase failed on those counts; the exact check is
# MULTI_FLOAT64 below
MULTI_FLOOR_BAND = 3
# the same structured cases with a float64 inner CG, through
# solve_structured(dtype=torch.float64, n_devices=D): (inner, outer,
# real dimE) of the JAX package's solve_structured(dtype=jnp.float64,
# n_devices=D), the same on 1, 2, 4 and 8 devices, taken as above with
#   from geneo4petsc_tpu.structured import grid
#   out = solve_structured(grid.<wl>_grid(16, dim=3, kappa_max=100.0,
#       interp="minmax"), (2, 2, 2), 1, geneo=<lvl>,
#       ksp=KSPOptions(type="cg", rtol=1e-8), dtype=jnp.float64,
#       n_devices=D)
# held exactly
MULTI_FLOAT64 = {("laplacian", "ASM,E1"): (33, 2, 8),
                 ("laplacian", "RAS,1"): (36, 2, 8),
                 ("heat", "SORAS,2"): (14, 2, 2368)}

# battery: the JAX package's on-chip battery (tst/smoke_tpu.py) with its
# builders and options, plus the non-separable case on the inexact route
# (block-tridiagonal budget 0); (name, grid, level, extra options)
BATTERY = [
    ("lap-ORAS,0", "lap", "ORAS,0", {}),
    ("lap-SORAS,2", "lap", "SORAS,2", {}),
    ("lap-SORAS,H2", "lap", "SORAS,H2", {}),
    ("lap-ASM,E1", "lap", "ASM,E1", {}),
    ("heat-SORAS,2", "heat", "SORAS,2", {}),
    ("nonsep-ASM,E1", "nonsep", "ASM,E1", {}),
    ("nonsep-ASM,E1-inexact", "nonsep", "ASM,E1", {"bt_budget_bytes": 0}),
    ("lap-ASM,E1-sharded1dev", "lap", "ASM,E1", {"n_devices": 1}),
    ("elas-RAS,1", "elas", "RAS,1", {}),
    ("elas-SORAS,2", "elas", "SORAS,2", {}),
]
BATTERY_GRIDS = {
    "lap": ("laplacian_grid", 24, dict(dim=3, kappa_max=1e4,
                                       interp="minmax")),
    "heat": ("heat_grid", 16, dict(dim=3, kappa_max=100.0, interp="minmax",
                                   lbd=1.0, dt=0.1)),
    "nonsep": ("inclusion_grid", 24, dict(dim=3, kappa_max=1e4, n_inc=8)),
    "elas": ("elastic_grid", 10, dict(kappa_max=100.0, interp="minmax",
                                      spring=100.0)),
}
BATTERY_DOMS, BATTERY_OVERLAP = (2, 2, 2), 1
# the JAX package's values on the CPU, float64, by the device refinement
# route (the card's default): (outer, inner, per-domain raw dim_e (GenEO-2)
# or real dim_e, level-1 solver) from
#   python -c "import jax; jax.config.update('jax_enable_x64', True)
#   import os, jax.numpy as jnp
#   from geneo4petsc_tpu.config import GenEOOptions, KSPOptions
#   from geneo4petsc_tpu.structured import grid as G
#   from geneo4petsc_tpu.structured.solve import solve_structured
#   from geneo4petsc_tpu.structured.elastic import elastic_grid, solve_elastic
#   o = GenEOOptions(); o.lvl1, o.lvl2 = LVL.split(','); o.els2.type = 'lobpcg'
#   # lap/heat/nonsep: o.cut = 2; nonsep also o.dls1.rtol, o.dls1.max_it
#   #   = 0.05, 40; -inexact: os.environ['GENEO_BT_BUDGET_GB'] = '0'
#   out = solve_structured(G.<grid>(<size>, **<options>), (2, 2, 2), 1,
#       geneo=o, ksp=KSPOptions(type='cg'), tol=1e-8, dtype=jnp.float64,
#       device_refine=True[, n_devices=1])
#   # elas: o.cut, o.tau, o.dls1.rtol, o.dls1.max_it = 8, 0.3, 0.02, 80
#   #   out = solve_elastic(elastic_grid(10, ...), (2, 2, 2), 1, o,
#   #       tol=1e-8, dtype=jnp.float64, device_refine=True)
#   print(out.refined.outer_its, out.refined.inner_its,
#         list(out.stats.raw_dim_e), list(out.stats.real_dim_e))"
# run from the repository root with JAX on the CPU, one call per case
# (BATTERY_GRIDS gives <grid>, <size> and <options>).  The port gives the
# same counts on the CPU (tests/test_torch_structured_general.py holds
# the general solvers against JAX there).
BATTERY_JAX = {
    "lap-ORAS,0": (3, 353, [0] * 8, "BTSolver"),
    "lap-SORAS,2": (2, 50, [1] * 8, "BTSolver"),
    "lap-SORAS,H2": (2, 43, [1] * 8, "BTSolver"),
    "lap-ASM,E1": (2, 32, [1] * 8, "FDMFactor"),
    "heat-SORAS,2": (2, 47, [1] * 8, "BTSolver"),
    "nonsep-ASM,E1": (2, 34, [1, 1, 1, 1, 1, 2, 2, 1], "BTSolver"),
    "nonsep-ASM,E1-inexact": (2, 44, [1, 1, 1, 1, 1, 2, 2, 1], "PCGSolver"),
    "lap-ASM,E1-sharded1dev": (2, 32, [1] * 8, "FDMFactor"),
    "elas-RAS,1": (2, 33, [8] * 8, "PCGSolver"),
    "elas-SORAS,2": (2, 111, [4] * 8, "PCGSolver"),
}
# inner iterations on an exact route (FDM, block-tridiagonal) within 1 of
# JAX's; on an inexact one (the level-1 PCG stops at rtol 0.05 / 0.02, so
# the card's rounding moves where it stops) within BATTERY_INEXACT_BAND
BATTERY_INEXACT_BAND = 5
# nonsep: bench.py nonsep10m (bench.py:403-488, mode at :884-886)
NONSEP_GRID = dict(size=216, dim=3, kappa_max=1e4, n_inc=27)
NONSEP_DOMS, NONSEP_OVERLAP = (4, 4, 4), 2
NONSEP_DOF = 10077696

LARGE_SIZE, LARGE_GRID = 512, 32   # bench.py:901-904, mode "large"
LARGE_CUT = 4
# generic-family: (label, CLI arguments, golden entry or None); the golden
# arguments are tst/iters.py's
_GOLDEN_KSP = ["-ksp_rtol", "1.e-05", "-ksp_atol", "1.e-05",
               "-ksp_max_it", "1000", "-ksp_gmres_restart", "1000"]
_LOBPCG_CASE = ["--inpLibA", "laplacian", "--inpLibArg",
                "--size#128#--dim#2#--kappa#10000.#minmax", "--nbPart", "64",
                "--addOverlap", "1", "-pc_type", "geneo", "-els2_type",
                "lobpcg", "-ksp_rtol", "1e-8"]
FAMILY_CASES = [
    ("heat dual ASM,1", ["--inpLibA", "heat", "--inpLibArg",
                         "--size#10#--weakScaling#1#--dim#2#--lbd#2.#--dt#0.5",
                         "--nbPart", "2", "--metisDual", *_GOLDEN_KSP,
                         "-pc_type", "geneo", "-geneo_lvl", "ASM,1",
                         "-geneo_tau", "0.1", "-geneo_gamma", "8."],
     "heat-np=2-pc=geneoASM1-metis=dual"),
    ("graph nodal SORAS,2", ["--inpLibA", "graph", "--inpLibArg",
                             "--size#16#--weakScaling#1", "--nbPart", "2",
                             "--metisNodal", *_GOLDEN_KSP, "-pc_type", "geneo",
                             "-geneo_lvl", "SORAS,2", "-geneo_tau", "0.1",
                             "-geneo_gamma", "8.", "-geneo_optim", "0.00"],
     "graph-np=2-pc=geneoSORAS2-metis=nodal"),
    ("laplacian dual bjacobi", ["--inpLibA", "laplacian", "--inpLibArg",
                                "--size#10#--weakScaling#1#--dim#2",
                                "--nbPart", "2", "--metisDual", *_GOLDEN_KSP,
                                "-pc_type", "bjacobi"],
     "laplacian-np=2-pc=bjacobi-metis=dual"),
    ("laplacian mg w 5/5", ["--inpLibA", "laplacian", "--inpLibArg",
                            "--size#64#--dim#2#--kappa#100.#minmax",
                            "--nbPart", "4", "-pc_type", "mg",
                            "-pc_mg_cycle_type", "w", "-pc_mg_smoothdown",
                            "5", "-pc_mg_smoothup", "5", "-ksp_type", "cg",
                            "-ksp_rtol", "1e-8"], None),
    ("laplacian 128 lobpcg ASM,E1", _LOBPCG_CASE + [
        "-geneo_lvl", "ASM,E1", "-ksp_type", "cg"], None),
    # SORAS is not symmetric: GMRES, the reference's KSP for it
    ("laplacian 128 lobpcg SORAS,E2", _LOBPCG_CASE + [
        "-geneo_lvl", "SORAS,E2", "-ksp_type", "gmres"], None),
]

_RE_SOLVE = re.compile(r"INFO: solve - (converged|diverged) \(([A-Z_]+)\), "
                       r"(\d+) iteration\(s\), residual norm \S+, "
                       r"\|\| AX - B \|\| / \|\| B \|\| (\S+)")
_RE_DOF = re.compile(r"INFO: nb DOFs (\d+),")
_RE_DIME = re.compile(r"real dimE (\d+) .*nicolaides (\d+)")
_RE_REFINED = re.compile(r"INFO: solve - (converged|diverged) \(refined, "
                         r"(\d+) outer\), (\d+) iteration\(s\), "
                         r"\|\| AX - B \|\| / \|\| B \|\| (\S+)")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _peaks() -> dict:
    from geneo4petsc_tpu_torch.utils import roofline

    peaks = roofline.device_peaks()
    check(peaks is not None, "the card has no row in the peaks table "
                             "(utils/roofline.py)")
    return peaks


def phase_device() -> None:
    import torch

    from geneo4petsc_tpu_torch.utils import roofline

    check(torch.cuda.is_available(), "no CUDA device (torch.cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(roofline.smi_line(), flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}", flush=True)
    peaks = _peaks()
    print(f"[device] peaks ({peaks['source']}): memory "
          f"{peaks['hbm_bytes_per_s']:.3g} B/s, " + ", ".join(
              f"{k} {v:.3g} FLOP/s" for k, v in peaks["flops"].items()),
          flush=True)


def phase_build() -> None:
    from geneo4petsc_tpu_torch.ops import _build
    from geneo4petsc_tpu_torch.partition import native

    t0 = time.perf_counter()
    path, report = _build.build(ptxas_info=True)
    t_cuda = time.perf_counter() - t0
    _build.load()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", report))
    print(f"[build] ptxas: {len(regs)} kernels, at most {max(regs)} "
          f"registers a thread, {spills} bytes of spills", flush=True)
    t0 = time.perf_counter()
    native.build()
    t_native = time.perf_counter() - t0
    check(native.available(), "native partitioner did not load")
    print(f"[build] kernels {os.path.relpath(path, HERE)} in {t_cuda:.2f} s,"
          f" native partitioner in {t_native:.2f} s", flush=True)


def _kernel_inputs(n_dom, n, dtype, aligned, rng, dev):
    """Seeded inputs of one case.  A misaligned case puts the matrix
    batch one element into a longer buffer: contiguous, but its base
    pointer is no multiple of 16 bytes."""
    import torch

    inv = torch.from_numpy(rng.standard_normal((n_dom, n, n))).to(dev, dtype)
    if not aligned:
        buf = torch.empty(inv.numel() + 1, dtype=dtype, device=dev)
        buf[1:].copy_(inv.flatten())
        inv = buf[1:].view(n_dom, n, n)
        check(inv.data_ptr() % 16 != 0 and inv.is_contiguous(),
              "the misaligned case is aligned")
    d = torch.from_numpy(rng.random((n_dom, n)) + 0.5).to(dev, dtype)
    mask = torch.from_numpy(rng.random((n_dom, n)) > 0.2).to(dev)
    x = torch.from_numpy(rng.standard_normal((n_dom, n))).to(dev, dtype)
    return inv, d, mask, x


def _kernel_runs(lk, inv, d, mask, x):
    """(name, variant, kernel call, plain call, whether it reads weights)
    of each kernel variant on one case's inputs."""
    runs = [("fused_local_solve", f"pre={pre} post={post}",
             lambda pre=pre, post=post: lk.fused_local_solve(
                 inv, d, mask, x, pre, post),
             lambda pre=pre, post=post: lk.fused_local_solve_plain(
                 inv, d, mask, x, pre, post),
             pre or post)
            for pre, post in ((False, False), (True, False), (True, True))]
    runs.append(("block_matvec", "", lambda: lk.block_matvec(inv, x),
                 lambda: lk.block_matvec_plain(inv, x), False))
    return runs


def kernel_bound(name: str, n_dom: int, n: int, dtype_name: str,
                 weights: bool, peaks: dict) -> tuple[int, float, str]:
    """(bytes, bound ms, bound by) of one call of kernel ``name`` on a
    [n_dom, n, n] batch: every input read once (the matrices and x; K1
    also its mask, a byte an entry, and with weights D), the output
    written once; 2 n^2 operations a domain."""
    from geneo4petsc_tpu_torch.utils import roofline

    isz = 8 if dtype_name == "float64" else 4
    moved = (n_dom * n * n + 2 * n_dom * n) * isz
    if name == "fused_local_solve":
        moved += n_dom * n * (1 + weights * isz)
    bound, by = roofline.bound_ms(moved, 2 * n_dom * n * n, dtype_name,
                                  peaks)
    return moved, bound, by


def _hold(name, variant, kern, plain, where, tol) -> tuple[float, float]:
    """Launch a kernel twice beside its plain version: the same bits both
    times, and within ``tol`` of the plain result (max relative error).
    Returns (max abs error, max relative error)."""
    import torch

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-300)
    check(rel_err <= tol, f"{name} {variant} {where} disagrees with its "
                          f"plain version: {rel_err:.3e} > {tol:g}")
    check(torch.equal(got, again), f"{name} {variant} {where}: two "
                                   "launches gave different bits")
    return abs_err, rel_err


def phase_kernels() -> None:
    """Each kernel against its plain version at every case of
    KERNEL_CASES, on the path the case must take."""
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for (n_dom, n), dtype_name, aligned, want_path in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        inv, d, mask, x = _kernel_inputs(n_dom, n, dtype, aligned, rng, dev)
        tol = TOL[dtype_name]
        where = (f"[{n_dom},{n},{n}] {dtype_name}"
                 f"{'' if aligned else ' misaligned'}")
        path = lk.plan_for(inv).path
        check(path == want_path, f"{where} took the {path} path, "
                                 f"expected {want_path}")
        for name, variant, kern, plain, _ in _kernel_runs(lk, inv, d, mask,
                                                          x):
            _, rel_err = _hold(name, variant, kern, plain, where, tol)
            print(f"[kernels] {name} {variant} {where} {path}: max rel err "
                  f"{rel_err:.3e} (tol {tol:g})", flush=True)
        del inv, d, mask, x
        torch.cuda.empty_cache()


def phase_path_shapes(seen: list) -> dict:
    """Each kernel at every shape a main path gave it: held against its
    plain version, then timed in turns with torch.bmm (the library call
    for the same product, which the port never calls on the card) and
    with the plain version, beside its bound.  ``seen``: (phase, n_dom,
    n_max, dtype name, launches per kernel) of every main-path run.
    Returns, per kernel, one row per shape."""
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.utils.cuda_timing import time_in_turns

    shapes = {}
    for phase, n_dom, n, dtype_name, launches in seen:
        for name, count in launches.items():
            if count:
                shapes.setdefault((n_dom, n, dtype_name), {}).setdefault(
                    name, set()).add(phase)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    peaks = _peaks()
    rows = {"fused_local_solve": [], "block_matvec": []}
    for (n_dom, n, dtype_name), kernels in sorted(
            shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1] ** 2):
        dtype = getattr(torch, dtype_name)
        inv, d, mask, x = _kernel_inputs(n_dom, n, dtype, True, rng, dev)
        tol = TOL[dtype_name]
        where = f"[{n_dom},{n},{n}] {dtype_name}"
        path = lk.plan_for(inv).path

        def lib():
            return torch.bmm(inv, x.unsqueeze(-1))

        for name, variant, kern, plain, weights in _kernel_runs(
                lk, inv, d, mask, x):
            # the main paths run ASM: K1 without weights
            if name not in kernels or variant not in (
                    "", "pre=False post=False"):
                continue
            abs_err, rel_err = _hold(name, variant, kern, plain, where, tol)
            moved, bound_ms, bound_by = kernel_bound(
                name, n_dom, n, dtype_name, weights, peaks)
            # in turns: library, kernel, kernel, library
            b, k = time_in_turns(lib, kern)
            _, p = time_in_turns(lib, plain, rounds=3)
            share = bound_ms / k["ms"]
            phases = sorted(kernels[name])
            print(f"[path-shapes] {name} {where} {path} ({', '.join(phases)})"
                  f": max rel err {rel_err:.3e} (tol {tol:g}); kernel "
                  f"{k['ms']:.4f} ms [{k['min_ms']:.4f}, {k['max_ms']:.4f}],"
                  f" torch.bmm {b['ms']:.4f} ms [{b['min_ms']:.4f}, "
                  f"{b['max_ms']:.4f}], plain {p['ms']:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({moved} B), share of bound "
                  f"{share:.3f}", flush=True)
            check(share <= 1.0, f"{name} {where}: {k['ms']:.4f} ms is under "
                                f"the bound {bound_ms:.4f} ms")
            rows[name].append(dict(
                phases=phases, shape=[n_dom, n, n], dtype=dtype_name,
                path=path, max_abs_err=abs_err, ms=k["ms"],
                ms_min=k["min_ms"], ms_max=k["max_ms"], library_ms=b["ms"],
                plain_ms=p["ms"], bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=share))
        del inv, d, mask, x
        torch.cuda.empty_cache()
    return rows


def _run_cli(args: list[str]) -> tuple[str, dict]:
    from geneo4petsc_tpu_torch import cli

    buf = io.StringIO()
    rc = cli.run(args, out=buf)
    log = buf.getvalue()
    check(rc == 0, f"CLI exited {rc}:\n{log}")
    m = _RE_SOLVE.search(log)
    check(m is not None, f"no solve line in the CLI output:\n{log}")
    info = {"status": m.group(1), "reason": m.group(2),
            "its": int(m.group(3)), "true_res": float(m.group(4))}
    md = _RE_DOF.search(log)
    info["n_dof"] = int(md.group(1)) if md else None
    me = _RE_DIME.search(log)
    if me:
        info["dim_e"], info["nicolaides"] = int(me.group(1)), int(me.group(2))
    return log, info


def phase_small() -> None:
    _, on_cpu = _run_cli(SMALL_ARGS + ["--device", "cpu"])
    _, on_cuda = _run_cli(SMALL_ARGS + ["--device", "cuda"])
    print(f"[small] laplacian 32x32, 8 domains: cpu {on_cpu['its']} its "
          f"{on_cpu['reason']} true_res {on_cpu['true_res']:g}; cuda "
          f"{on_cuda['its']} its {on_cuda['reason']} true_res "
          f"{on_cuda['true_res']:g}", flush=True)
    check(on_cpu["status"] == "converged", "small case did not converge")
    check((on_cpu["its"], on_cpu["reason"])
          == (on_cuda["its"], on_cuda["reason"]),
          "small case: cpu and cuda disagree on iterations or reason")


def phase_slice() -> dict:
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    t0 = time.perf_counter()
    log, info, out = _run_cli_keep(SLICE_ARGS + ["--device", "cuda",
                                                 "--timing"])
    wall = time.perf_counter() - t0
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    batch = out.assembled.batch
    shape = ("slice", batch.n_dom, batch.n_max, str(batch.dtype)[6:],
             launches)
    del out, batch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in log.splitlines():
        if line.startswith(("INFO", "WRNG", "TIME", "      ")):
            print(f"[slice] {line}", flush=True)
    print(f"[slice] wall {wall:.2f} s, peak device memory {peak_gb:.2f} GB, "
          f"launches {launches}", flush=True)
    its = info["its"]
    check(info["reason"] == "KSP_CONVERGED_RTOL",
          f"slice did not converge: {info['reason']}")
    check(info["n_dof"] == SLICE_DOF, f"slice DOFs {info['n_dof']}")
    check(info.get("dim_e") == SLICE_DIM_E, f"slice dim_e {info.get('dim_e')}")
    check(info.get("nicolaides") == SLICE_NICOLAIDES,
          f"slice nicolaides {info.get('nicolaides')}")
    check(abs(its - SLICE_ITS) <= 1, f"slice iterations {its}")
    check(info["true_res"] <= 1e-9, f"slice true residual {info['true_res']}")
    # the wrappers launch a kernel only for CUDA tensors, so these counts
    # also show that the solve's vectors lived on the card
    check(launches["fused_local_solve"] >= its,
          f"K1 launched {launches['fused_local_solve']} < {its} times")
    check(launches["block_matvec"] >= 2 * its,
          f"K2 launched {launches['block_matvec']} < {2 * its} times")
    check(peak_gb >= 4.0, f"peak device memory {peak_gb:.2f} GB: the "
                          "operator blocks did not live on the card")
    info.update(wall_s=wall, timing=[ln.strip() for ln in log.splitlines()
                                     if ln.startswith(("TIME", "      "))])
    return launches, shape, info


def phase_structured_parity() -> None:
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured

    for route, device_refine in (("host", False), ("device", True)):
        g = GenEOOptions()
        g.lvl1, g.lvl2 = "ASM", "E1"
        g.els2.type, g.els2.max_it, g.cut = "lobpcg", 50, 2
        t0 = time.perf_counter()
        out = solve_structured(laplacian_grid(**PARITY_GRID), PARITY_DOMS,
                               PARITY_OVERLAP, geneo=g,
                               ksp=KSPOptions(type="cg"), tol=1e-8,
                               dtype=torch.float64, device="cuda",
                               device_refine=device_refine)
        wall = time.perf_counter() - t0
        want = PARITY_JAX[route]
        dim_e = [int(v) for v in out.stats.real_dim_e]
        nic = [int(v) for v in out.stats.nicolaides]
        print(f"[structured-parity] {route} refinement: {out.refined.outer_its}"
              f" outer / {out.refined.inner_its} inner (JAX on the CPU: "
              f"{want['outer']} / {want['inner']}), dim_e {dim_e}, "
              f"nicolaides {sum(nic)}, true_res {out.true_res:.3e} (JAX "
              f"{want['true_res']:.3e}), {wall:.2f} s", flush=True)
        check(out.pc.z.device.type == "cuda", "the coarse basis is not on "
                                              "the card")
        check(dim_e == PARITY_DIM_E, f"structured-parity dim_e {dim_e}")
        check(nic == PARITY_NICOLAIDES, f"structured-parity nicolaides {nic}")
        check(out.refined.outer_its == want["outer"],
              f"structured-parity outer passes {out.refined.outer_its}")
        check(abs(out.refined.inner_its - want["inner"]) <= 1,
              f"structured-parity inner iterations {out.refined.inner_its}")
        check(out.converged and out.true_res <= 1e-8,
              f"structured-parity true residual {out.true_res}")


def phase_structured() -> dict:
    import torch

    from geneo4petsc_tpu_torch import cli
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.structured import solve as ssolve
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid

    # keep the CLI's solve output, for the error against x = 1..n
    seen = {}
    solve = ssolve.solve_structured

    def keep(*args, **kw):
        seen["out"] = solve(*args, **kw)
        return seen["out"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    ssolve.solve_structured = keep
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        rc = cli.run(STRUCTURED_ARGS + ["--device", "cuda"], out=buf)
    finally:
        ssolve.solve_structured = solve
    wall = time.perf_counter() - t0
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = buf.getvalue()
    for line in log.splitlines():
        if line.startswith(("INFO", "WRNG", "TIME", "      ")):
            print(f"[structured] {line}", flush=True)
    check(rc == 0, f"structured CLI exited {rc}:\n{log}")
    m = _RE_REFINED.search(log)
    check(m is not None, f"no solve line in the structured output:\n{log}")
    md, me = _RE_DOF.search(log), _RE_DIME.search(log)
    out = seen["out"]
    n = STRUCTURED_DOF
    x = np.asarray(out.x, np.float64)
    err = float(np.max(np.abs(x - np.arange(1.0, n + 1)))) / n
    t0 = time.perf_counter()
    grid = laplacian_grid(216, dim=3, kappa_max=10000.0, interp="minmax")
    host_res = float(np.linalg.norm(out.b - grid.matvec(x))
                     / np.linalg.norm(out.b))
    t_host = time.perf_counter() - t0
    info = {"dim_e": int(me.group(1)), "nicolaides": int(me.group(2)),
            "outer": int(m.group(2)), "inner": int(m.group(3)),
            "true_res": float(m.group(4)), "wall_s": wall,
            "peak_gb": peak_gb}
    print(f"[structured] {n} DOF on the card: {info['inner']} inner / "
          f"{info['outer']} outer iterations, dim_e {info['dim_e']}, "
          f"true_res {out.true_res:.3e} (host float64 recheck "
          f"{host_res:.3e} in {t_host:.1f} s), max |x - x_true| / n "
          f"{err:.3e}; CLI wall {wall:.2f} s, peak device memory "
          f"{peak_gb:.2f} GB; K1/K2 launches on this path {launches}",
          flush=True)
    print(f"[structured] reference, not a target — the JAX package on a "
          f"TPU v5e (BENCH_r05.json): {JAX_TPU_RECORD}", flush=True)
    check(md is not None and int(md.group(1)) == n,
          f"structured DOFs {md and md.group(1)}")
    check(m.group(1) == "converged", "the structured case did not converge")
    check(out.true_res <= 1e-8 and host_res <= 1e-8,
          f"structured true residual {out.true_res} / host {host_res}")
    check(bool(np.isfinite(x).all()), "non-finite solution")
    check(out.pc.z is not None and out.pc.z.device.type == "cuda",
          "the preconditioner did not live on the card")
    check(launches == {"fused_local_solve": 0, "block_matvec": 0},
          f"K1/K2 launched on the structured path: {launches}")
    check(peak_gb >= 1.0, f"peak device memory {peak_gb:.2f} GB: the "
                          "structured operators did not live on the card")
    return info


def _l1_tensor(l1):
    """A tensor of a level-1 solver, for its device (and finiteness)."""
    return {"FDMFactor": lambda: l1.den, "BTSolver": lambda: l1.fac.w,
            "PCGSolver": lambda: l1.maskf}[type(l1).__name__]()


def _battery_case(name, kind, lvl, extra):
    """One battery case on the card in float64, from the JAX package's
    start block; returns the solve's output and its seconds."""
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.perf.lobpcg_start import jax_start
    from geneo4petsc_tpu_torch.structured import elastic
    from geneo4petsc_tpu_torch.structured import grid as sgrid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured

    builder, size, kw = BATTERY_GRIDS[kind]
    o = GenEOOptions()
    o.lvl1, o.lvl2 = lvl.split(",")
    o.els2.type = "lobpcg"
    t0 = time.perf_counter()
    if kind == "elas":
        o.cut, o.tau = 8, 0.3
        o.dls1.rtol, o.dls1.max_it = 0.02, 80
        out = elastic.solve_elastic(
            elastic.elastic_grid(size, **kw), BATTERY_DOMS, BATTERY_OVERLAP,
            o, tol=1e-8, dtype=torch.float64, setup_dtype=torch.float64,
            device="cuda", lobpcg_start=jax_start)
    else:
        o.cut = 2
        if kind == "nonsep":
            o.dls1.rtol, o.dls1.max_it = 0.05, 40
        out = solve_structured(
            getattr(sgrid, builder)(size, **kw), BATTERY_DOMS,
            BATTERY_OVERLAP, geneo=o, ksp=KSPOptions(type="cg"), tol=1e-8,
            dtype=torch.float64, device="cuda", lobpcg_start=jax_start,
            **extra)
    return out, time.perf_counter() - t0


def phase_battery() -> dict:
    """The JAX package's on-chip battery through the port on the card
    (see the docstring): each case held to the JAX package's float64
    counts on the CPU (BATTERY_JAX), its route and where its factors
    live; the TPU's record printed beside it, not held."""
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    with open(os.path.join(HERE, "tst", "golden",
                           "smoke_tpu_results.json")) as f:
        tpu = json.load(f)
    lk.fused_local_solve.launches = lk.block_matvec.launches = 0
    t_phase = time.perf_counter()
    for name, kind, lvl, extra in BATTERY:
        torch.cuda.empty_cache()
        out, wall = _battery_case(name, kind, lvl, extra)
        outer, inner, dims, route = BATTERY_JAX[name]
        st, pc = out.stats, out.pc
        raw = [int(v) for v in (st.raw_dim_e if st.raw_dim_e is not None
                                else st.real_dim_e)]
        real = [int(v) for v in st.real_dim_e]
        got_route = None if pc is None else type(pc.l1).__name__
        exact = route != "PCGSolver"
        band = 1 if exact else BATTERY_INEXACT_BAND
        t = tpu["cases"].get(name)
        ref = ("none" if t is None else
               f"{t['its']} inner / {t['outer']} outer, dim_e {t['dim_e']}, "
               f"true_res {t['true_res']:.3e}, {t['wall_s']} s")
        print(f"[battery] {name}: {out.refined.inner_its} inner / "
              f"{out.refined.outer_its} outer (JAX float64 on the CPU: "
              f"{inner} / {outer}), dim_e {sum(real)} per domain {real}"
              f"{f' raw {raw}' if lvl.endswith('2') else ''}, level-1 "
              f"{got_route or 'on the rank'}, true_res "
              f"{out.true_res:.3e}, {wall:.2f} s; TPU v5 lite, JAX (not "
              f"held): {ref}", flush=True)
        check(out.converged and out.true_res <= 1e-8,
              f"battery {name}: not converged to 1e-8 ({out.true_res})")
        check(bool(np.isfinite(out.x).all()),
              f"battery {name}: non-finite solution")
        check(out.refined.outer_its == outer,
              f"battery {name}: {out.refined.outer_its} outer passes != "
              f"JAX's {outer}")
        if lvl.endswith("2"):
            check(raw == dims and sum(real) == sum(dims),
                  f"battery {name}: raw dim_e {raw} (real {real}) != "
                  f"JAX's {dims}")
        else:
            check(real == dims, f"battery {name}: dim_e {real} != JAX's "
                                f"{dims}")
        check(abs(out.refined.inner_its - inner) <= band,
              f"battery {name}: {out.refined.inner_its} inner iterations, "
              f"JAX's {inner} (band {band})")
        if pc is None:      # the spawned rank hands back no preconditioner
            continue
        check(got_route == route, f"battery {name}: level-1 solver "
                                  f"{got_route}, expected {route}")
        # the elastic level-1 solver is always the PCG one
        check(getattr(pc, "l1_exact", False) == exact,
              f"battery {name}: l1_exact {getattr(pc, 'l1_exact', None)}")
        factor = _l1_tensor(pc.l1)
        check(factor.device.type == "cuda"
              and bool(torch.isfinite(factor).all()),
              f"battery {name}: the level-1 factors are not finite on the "
              "card")
        check(pc.z is None or pc.z.device.type == "cuda",
              f"battery {name}: the coarse basis is not on the card")
        del out, pc, factor
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    print(f"[battery] {len(BATTERY)} cases in "
          f"{time.perf_counter() - t_phase:.1f} s (TPU v5 lite, JAX, its "
          f"9 cases: {tpu['wall_s']} s); K1/K2 launches {launches}",
          flush=True)
    check(launches == {"fused_local_solve": 0, "block_matvec": 0},
          f"battery: K1/K2 launched {launches}")
    return launches


def phase_nonsep() -> dict:
    """bench.py nonsep10m through solve_structured at full size on the
    card's default plan (see the docstring); then the level-1 PCG's host
    checks timed against the same iterations without them."""
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.structured import solve as ssolve
    from geneo4petsc_tpu_torch.structured.grid import inclusion_grid
    from geneo4petsc_tpu_torch.structured.solvers import PCGSolver
    from geneo4petsc_tpu_torch.utils.cuda_timing import time_in_turns
    from geneo4petsc_tpu_torch.utils.timers import Timers

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = lk.block_matvec.launches = 0
    t0 = time.perf_counter()
    grid = inclusion_grid(**NONSEP_GRID)
    t_gen = time.perf_counter() - t0
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "E1"
    opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 50, 2
    opts.dls1.rtol, opts.dls1.max_it = 0.05, 40
    timers = Timers()
    # the PCG counts at the start of the solve phase: the setup's are the
    # shift-invert LOBPCG's, the solve's the level-1 applies'
    at_solve = {}
    refine = ssolve.refined_solve_device

    def mark(*a, **kw):
        at_solve.update(solves=PCGSolver.solves,
                        iterations=PCGSolver.iterations)
        return refine(*a, **kw)

    PCGSolver.solves = PCGSolver.iterations = 0
    ssolve.refined_solve_device = mark
    t0 = time.perf_counter()
    try:
        # the card's default plan: float32 inner solves in float64
        # refinement, the device refinement route
        out = ssolve.solve_structured(grid, NONSEP_DOMS, NONSEP_OVERLAP,
                                      geneo=opts, ksp=KSPOptions(type="cg"),
                                      tol=1e-8, timers=timers,
                                      device="cuda")
    finally:
        ssolve.refined_solve_device = refine
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    setup_pcg = (at_solve["solves"], at_solve["iterations"])
    solve_pcg = (PCGSolver.solves - setup_pcg[0],
                 PCGSolver.iterations - setup_pcg[1])
    n = grid.n_nodes
    x = np.asarray(out.x, np.float64)
    err = float(np.max(np.abs(x - np.arange(1.0, n + 1)))) / n
    t0 = time.perf_counter()
    host_res = float(np.linalg.norm(out.b - grid.matvec(x))
                     / np.linalg.norm(out.b))
    t_host = time.perf_counter() - t0
    st, tm, pc = out.stats, timers.get, out.pc
    info = {"n_dof": n, "dim_e": int(st.real_dim_e.sum()),
            "nicolaides": int(st.nicolaides.sum()),
            "inner": out.refined.inner_its, "outer": out.refined.outer_its,
            "true_res": out.true_res, "host_res": host_res,
            "rel_err_max": err, "peak_gb": peak_gb, "wall_s": wall,
            "generator_s": t_gen, "createA_s": tm("createA"),
            "l1_s": tm("l1_minv"), "l2_eig_s": tm("l2_eig"),
            "setup_s": tm("setup"), "solve_s": tm("solve"),
            "lobpcg_pcg": setup_pcg, "l1_pcg": solve_pcg,
            "history": out.refined.history}
    print(f"[nonsep] {n} DOF (inclusion_grid {NONSEP_GRID['size']}^3, "
          f"{NONSEP_GRID['n_inc']} inclusions, kappa "
          f"{NONSEP_GRID['kappa_max']:g}), 4x4x4 boxes of {pc.local_shape} "
          f"nodes, overlap "
          f"{NONSEP_OVERLAP}: level-1 {type(pc.l1).__name__} (l1_exact "
          f"{pc.l1_exact}), {info['inner']} inner / {info['outer']} outer "
          f"iterations, dim_e {info['dim_e']} (per domain "
          f"{int(st.real_dim_e.min())}-{int(st.real_dim_e.max())}, "
          f"nicolaides {info['nicolaides']}), true_res {out.true_res:.3e} "
          f"(host float64 recheck {host_res:.3e} in {t_host:.1f} s), "
          f"rel_err_max {err:.3e}, refinement history "
          f"{out.refined.history}", flush=True)
    print(f"[nonsep] phases: generator {t_gen:.3f} s, createA "
          f"{tm('createA'):.3f} s, setup {tm('setup'):.3f} s (L1 "
          f"{tm('l1_minv'):.3f} s, l2_eig {tm('l2_eig'):.3f} s, Z "
          f"{tm('l2_z'):.3f} s, E {tm('l2_e'):.3f} s), solve "
          f"{tm('solve'):.3f} s; library wall {wall:.2f} s, peak device "
          f"memory {peak_gb:.2f} GB; PCG: shift-invert LOBPCG "
          f"{setup_pcg[0]} solves / {setup_pcg[1]} iterations, level-1 "
          f"{solve_pcg[0]} applies / {solve_pcg[1]} iterations "
          f"({solve_pcg[1] / max(solve_pcg[0], 1):.2f} an apply, cap "
          f"{opts.dls1.max_it}); K1/K2 launches {launches}", flush=True)
    check(out.converged and out.true_res <= 1e-8 and host_res <= 1e-8,
          f"nonsep: not converged to 1e-8 (true_res {out.true_res}, host "
          f"{host_res})")
    check(bool(np.isfinite(x).all()), "nonsep: non-finite solution")
    check(type(pc.l1).__name__ == "PCGSolver" and not pc.l1_exact,
          f"nonsep: level-1 {type(pc.l1).__name__}, expected the inexact "
          "PCG route")
    check(setup_pcg[0] > 0, "nonsep: the shift-invert LOBPCG ran no PCG")
    check(pc.z is not None and pc.z.device.type == "cuda"
          and pc.l1.maskf.device.type == "cuda",
          "nonsep: the preconditioner did not live on the card")
    check(launches == {"fused_local_solve": 0, "block_matvec": 0},
          f"nonsep: K1/K2 launched {launches}")

    # the level-1 solve's per-iteration host check (PCGSolver.solve's
    # busy()): one apply as the solve runs it, in turns with the same
    # number of iterations enqueued without the checks (CUDA events)
    l1 = pc.l1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rhs = torch.randn(l1.maskf.shape, generator=gen, device="cuda",
                      dtype=l1.maskf.dtype) * l1.maskf
    before = PCGSolver.iterations
    l1.solve(rhs)
    k = PCGSolver.iterations - before

    def unchecked():
        m, _tol2, state = l1.start(rhs)
        for _ in range(k):
            state = l1.step(m, state)
        return state[0] * m

    checked, free = time_in_turns(lambda: l1.solve(rhs), unchecked,
                                  reps=2, rounds=3, warmup=1)
    per_it = (checked["ms"] - free["ms"]) / max(k, 1)
    total_its = setup_pcg[1] + solve_pcg[1]
    share = per_it * total_its / 1e3 / (tm("setup") + tm("solve"))
    info.update(apply_ms=checked["ms"], apply_unchecked_ms=free["ms"],
                apply_its=k, check_ms_per_it=per_it, check_share=share,
                launches=launches)
    print(f"[nonsep] level-1 apply ({k} PCG iterations, float32): "
          f"{checked['ms']:.3f} ms [{checked['min_ms']:.3f}, "
          f"{checked['max_ms']:.3f}] with a host check an iteration, "
          f"{free['ms']:.3f} ms [{free['min_ms']:.3f}, {free['max_ms']:.3f}]"
          f" without (CUDA events, in turns): {per_it:.4f} ms a check; "
          f"over the run's {total_its} PCG iterations about "
          f"{per_it * total_its / 1e3:.2f} s, {share:.3f} of setup + "
          "solve", flush=True)
    return info


def phase_large(slice_info: dict) -> dict:
    """bench.py large through the port's library (see the docstring)."""
    import torch

    from geneo4petsc_tpu_torch.assembly.assemble import assemble
    from geneo4petsc_tpu_torch.config import GenEOOptions
    from geneo4petsc_tpu_torch.krylov.refine import (make_pc_inner_solver,
                                                     refined_solve)
    from geneo4petsc_tpu_torch.models import laplacian
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.partition.decompose import decompose_nodal_fast
    from geneo4petsc_tpu_torch.partition.kway import partition_structured_grid
    from geneo4petsc_tpu_torch.precond import geneo
    from geneo4petsc_tpu_torch.utils.timers import Timers

    dev = torch.device("cuda")
    size, n_grid = LARGE_SIZE, LARGE_GRID
    n_dom = n_grid * n_grid
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    mesh = laplacian.get_input(f"--size {size} --dim 2 --kappa 10000. minmax")
    t["generator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = partition_structured_grid((size, size), (n_grid, n_grid))
    decomp = decompose_nodal_fast(mesh, part, n_dom)
    t["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap = assemble(mesh, decomp, dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t["assemble"] = time.perf_counter() - t0

    # where the LOBPCG pencils lived (the eigensolve runs where they are)
    seen = []
    lobpcg = geneo.batched_lobpcg

    def record(a, b, *args, **kw):
        seen.append((a.device.type, b.device.type, tuple(a.shape)))
        return lobpcg(a, b, *args, **kw)

    opts = GenEOOptions()
    opts.lvl1, opts.lvl2, opts.cut = "ASM", "E1", LARGE_CUT
    opts.dls1.type, opts.els2.type = "inverse_pallas", "lobpcg"
    timers = Timers()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    geneo.batched_lobpcg = record
    t0 = time.perf_counter()
    try:
        pc, stats = geneo.setup_geneo(ap.batch, opts, decomp=decomp,
                                      timers=timers, a_csr=ap.a_csr)
        torch.cuda.synchronize()
    finally:
        geneo.batched_lobpcg = lobpcg
    t["setup"] = time.perf_counter() - t0

    n = mesh.n_nodes
    x_true = np.arange(1.0, n + 1)
    b = np.asarray(ap.a_csr @ x_true)

    def residual64(x):
        return b - ap.a_csr @ x

    t0 = time.perf_counter()
    r = refined_solve(b, residual64, make_pc_inner_solver(pc), tol=1e-8,
                      max_outer=14, device=dev)
    torch.cuda.synchronize()
    t["solve"] = time.perf_counter() - t0
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_res = float(np.linalg.norm(residual64(r.x)) / np.linalg.norm(b))
    err = float(np.max(np.abs(r.x - x_true))) / n
    dim_e = int(stats.real_dim_e.sum())
    nic = int(stats.nicolaides.sum())
    res_max = float(stats.lobpcg_res.max())
    tm = timers.get
    info = {"n_dof": n, "n_dom": n_dom, "n_max": ap.batch.n_max,
            "dim_e": dim_e, "nicolaides": nic,
            "inner_its": r.inner_its, "outer_its": r.outer_its,
            "true_res": r.true_res, "host_res": host_res,
            "rel_err_max": err, "converged": bool(r.converged),
            "peak_gb": peak_gb, "launches": launches,
            **{f"{k}_s": v for k, v in t.items()},
            "l1_s": tm("l1_minv"), "l2_eig_s": tm("l2_eig"),
            "l2_pencil_s": tm("l2_pencil"), "l2_lobpcg_s": tm("l2_lobpcg"),
            "z_s": tm("l2_z"), "e_s": tm("l2_e"),
            "lobpcg_res_max": res_max, "history": r.history,
            "shape": ("large", n_dom, ap.batch.n_max, "float32", launches)}
    print(f"[large] {n} DOF, {n_dom} domains (n_max {ap.batch.n_max}), "
          f"float32: generator {t['generator']:.3f} s, partition "
          f"{t['partition']:.3f} s, assemble {t['assemble']:.3f} s, setup "
          f"{t['setup']:.3f} s (L1 {tm('l1_minv'):.3f} s, L2 eigensolve "
          f"{tm('l2_eig'):.3f} s = pencils {tm('l2_pencil'):.3f} s + LOBPCG "
          f"{tm('l2_lobpcg'):.3f} s, Z {tm('l2_z'):.3f} s, E "
          f"{tm('l2_e'):.3f} s), solve {t['solve']:.3f} s", flush=True)
    print(f"[large] dim_e {dim_e} (cut {LARGE_CUT}, nicolaides {nic}), "
          f"{r.inner_its} inner / {r.outer_its} outer iterations, true_res "
          f"{r.true_res:.3e} (host float64 recheck {host_res:.3e}), max "
          f"|x - x_true| / n {err:.3e}, kept LOBPCG residual max "
          f"{res_max:.3e}, peak device memory {peak_gb:.2f} GB, LOBPCG "
          f"pencils {seen}, launches {launches}", flush=True)
    print(f"[large] reference, not a check — the slice (phase 5: same mesh, "
          f"k-way dual partition with overlap 1, float64, host LAPACK "
          f"eigensolve): {slice_info['its']} its, dim_e "
          f"{slice_info.get('dim_e')}, CLI wall {slice_info['wall_s']:.2f} s; "
          + " | ".join(slice_info["timing"][:3]), flush=True)
    check(r.converged and r.true_res <= 1e-8 and host_res <= 1e-8,
          f"large: not converged to 1e-8 (true_res {r.true_res}, host "
          f"{host_res})")
    check(bool(np.isfinite(r.x).all()), "large: non-finite solution")
    check(dim_e <= LARGE_CUT * n_dom + nic, f"large: dim_e {dim_e}")
    check(seen and all(a == "cuda" and b_ == "cuda" for a, b_, _ in seen),
          f"large: the LOBPCG pencils were not on the card: {seen}")
    check(tm("l2_pencil") > 0 and tm("l2_lobpcg") > 0,
          "large: no pencil or LOBPCG time recorded")
    check(pc.l1_factor.dtype == torch.float32
          and pc.l1_factor.device.type == "cuda",
          "large: the level-1 inverses are not float32 on the card")
    check(launches["fused_local_solve"] >= r.inner_its,
          f"large: K1 launched {launches['fused_local_solve']} < "
          f"{r.inner_its} times")
    check(launches["block_matvec"] >= 2 * r.inner_its,
          f"large: K2 launched {launches['block_matvec']} < "
          f"{2 * r.inner_its} times")
    return info


def _run_cli_keep(args: list[str]):
    """_run_cli, also returning the solve's SolveOutput."""
    from geneo4petsc_tpu_torch import solver

    seen = {}
    solve = solver.solve_assembled

    def keep(*a, **kw):
        seen["out"] = solve(*a, **kw)
        return seen["out"]

    solver.solve_assembled = keep
    try:
        log, info = _run_cli(args)
    finally:
        solver.solve_assembled = solve
    return log, info, seen["out"]


def phase_generic_family() -> tuple[dict, list]:
    """The generic path's other modules on cpu and cuda (see the
    docstring); returns the K1/K2 launches of the cuda runs, and each
    cuda run's batch shape with its launches."""
    import torch

    from geneo4petsc_tpu_torch.ops import batched_linalg as bl
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.precond import geneo
    from geneo4petsc_tpu_torch.utils.cuda_timing import time_ms

    with open(os.path.join(HERE, "tst", "golden",
                           "iteration_counts.json")) as f:
        golden = json.load(f)
    launches = {"fused_local_solve": 0, "block_matvec": 0}
    shapes = []
    for label, args, entry in FAMILY_CASES:
        t0 = time.perf_counter()
        _, on_cpu, out_cpu = _run_cli_keep(args + ["--device", "cpu"])
        t1 = time.perf_counter()
        lk.fused_local_solve.launches = 0
        lk.block_matvec.launches = 0
        _, on_cuda, out_cuda = _run_cli_keep(args + ["--device", "cuda"])
        t2 = time.perf_counter()
        case = {name: getattr(lk, name).launches for name in launches}
        for name in launches:
            launches[name] += case[name]
        batch = out_cuda.assembled.batch
        shapes.append(("generic-family", batch.n_dom, batch.n_max,
                       str(batch.dtype)[6:], case))
        keys = ("status", "reason", "its", "dim_e", "nicolaides")
        got = {k: on_cuda.get(k) for k in keys}
        want = {k: on_cpu.get(k) for k in keys}
        line = (f"[generic-family] {label}: cpu {want['its']} its "
                f"{want['reason']}, cuda {got['its']} its {got['reason']}")
        if got["dim_e"] is not None:
            line += f", dim_e {got['dim_e']}, nicolaides {got['nicolaides']}"
        st_cpu, st_cuda = out_cpu.stats, out_cuda.stats
        if st_cuda is not None and st_cuda.lobpcg_res is not None:
            line += (f", estim dim_e {int(st_cuda.estim_dim_e.sum())}, "
                     f"L2 eigensolve cuda {out_cuda.timers.get('l2_eig'):.3f}"
                     f" s (inertia {out_cuda.timers.get('l2_inertia'):.3f} s,"
                     f" LOBPCG {out_cuda.timers.get('l2_lobpcg'):.3f} s)")
        if entry is not None:
            line += f", golden {golden[entry]}"
        print(f"{line}; cpu {t1 - t0:.2f} s, cuda {t2 - t1:.2f} s",
              flush=True)
        check(want["status"] == "converged", f"{label}: did not converge")
        check(got == want, f"{label}: cpu {want} != cuda {got}")
        check(out_cuda.assembled.batch.device.type == "cuda",
              f"{label}: the cuda run's operator is not on the card")
        if st_cuda is not None:
            for name in ("estim_dim_e", "real_dim_e", "nicolaides"):
                check(np.array_equal(getattr(st_cpu, name),
                                     getattr(st_cuda, name)),
                      f"{label}: per-domain {name} differ between cpu "
                      "and cuda")
        if entry is not None:
            pinned = {k: got[k] for k in golden[entry]}
            check(pinned == golden[entry],
                  f"{label}: {pinned} != golden {golden[entry]}")
        if label.endswith("lobpcg ASM,E1"):
            check(int(st_cuda.estim_dim_e.sum()) > 0,
                  f"{label}: no inertia estimates")
            a, b = geneo._pencil_tau_device(batch, 1e6)
            s_mat = a - 0.1 * b
            on_card = bl.ldlt_inertia(s_mat, batch.mask)
            on_host = bl.ldlt_inertia(s_mat.cpu(), batch.mask.cpu())
            check(all(torch.equal(x.cpu(), y)
                      for x, y in zip(on_card, on_host)),
                  f"{label}: the inertia counts differ between the card "
                  "and the host")
            ms_ldlt = time_ms(lambda: bl.ldlt_inertia(s_mat, batch.mask), 3)
            ms_eig = time_ms(lambda: torch.linalg.eigvalsh(s_mat), 3)
            print(f"[generic-family] inertia route at [{batch.n_dom}, "
                  f"{batch.n_max}, {batch.n_max}] float64 on the card: "
                  f"LDL^T (torch, one pivot a step on the trailing block) "
                  f"{ms_ldlt:.2f} ms, counts equal to the host's; "
                  f"torch.linalg.eigvalsh of the same batch {ms_eig:.2f} "
                  "ms (a reference)", flush=True)
    return launches, shapes


def _two_domain_poisson(n: int, overlap: int):
    """The JAX package's tests/test_api.py problem: 1-D Poisson (plus
    0.01 I) split into two overlapping domains, with PRE-WEIGHTED
    Neumann blocks (an entry both domains hold counts half in each)."""
    import scipy.sparse as sp

    a = sp.diags([[-1.0] * (n - 1), [2.0] * n, [-1.0] * (n - 1)],
                 [-1, 0, 1]).tocsr() + sp.eye(n) * 0.01
    half = n // 2
    g0, g1 = np.arange(0, half + overlap), np.arange(half - overlap, n)
    shared = np.intersect1d(g0, g1)
    mult = np.ones(n)
    mult[shared] = 2.0
    dense = a.toarray()

    def neu(g):
        w = dense[np.ix_(g, g)].copy()
        both = np.isin(g, shared)
        w[np.ix_(both, both)] /= 2.0
        return w

    inter = [[np.zeros(0, np.int64), np.searchsorted(g0, shared)],
             [np.searchsorted(g1, shared), np.zeros(0, np.int64)]]
    return a, [g0, g1], [neu(g0), neu(g1)], [mult[g0], mult[g1]], inter


def phase_api() -> tuple[dict, list]:
    """The library entry point on cpu and cuda (see the docstring);
    returns the K1/K2 launches of the cuda runs and their batch shapes."""
    from geneo4petsc_tpu_torch import api
    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    n = API_N
    a, gids, blocks, mults, inter = _two_domain_poisson(n, API_OVERLAP)
    x_true = np.arange(1.0, n + 1)
    b = a @ x_true
    cases = [("ASM,1 inverse_pallas cg", "ASM,1", "inverse_pallas", "cg",
              None),
             ("SORAS,2 intersections gmres", "SORAS,2", "cholesky", "gmres",
              inter)]
    launches = {"fused_local_solve": 0, "block_matvec": 0}
    shapes = []
    for label, lvl, dls1, ksp_type, its in cases:
        got = {}
        for dev in ("cpu", "cuda"):
            lk.fused_local_solve.launches = 0
            lk.block_matvec.launches = 0
            batch = api.make_batch(n, gids, blocks, mults, device=dev)
            opts = GenEOOptions()
            opts.lvl1, opts.lvl2 = lvl.split(",")
            opts.dls1.type = dls1
            pc, st = api.geneo_setup(batch, opts, b=b, intersections=its)
            res = api.geneo_solve(batch, b, pc,
                                  KSPOptions(type=ksp_type, rtol=1e-10))
            x = res.x.cpu().numpy()
            got[dev] = (res.its, res.reason, int(st.real_dim_e.sum()),
                        float(np.abs(x - x_true).max()))
            if dev == "cuda":
                check(batch.a_neu.device.type == "cuda" and
                      res.x.device.type == "cuda", f"api {label}: the "
                      "solve did not run on the card")
                case = {k: getattr(lk, k).launches for k in launches}
                for k in launches:
                    launches[k] += case[k]
                shapes.append(("api", batch.n_dom, batch.n_max,
                               str(batch.dtype)[6:], case))
        print(f"[api] {label}: cpu {got['cpu'][0]} its reason "
              f"{got['cpu'][1]}, cuda {got['cuda'][0]} its reason "
              f"{got['cuda'][1]}, dim_e {got['cuda'][2]}, max |x - x_true| "
              f"{got['cuda'][3]:.2e}; cuda launches {case}", flush=True)
        check(got["cpu"][:3] == got["cuda"][:3],
              f"api {label}: cpu {got['cpu']} != cuda {got['cuda']}")
        check(got["cuda"][1] > 0 and got["cuda"][3] <= 1e-5,
              f"api {label}: not converged to x = 1..n: {got['cuda']}")
        check(case["block_matvec"] >= got["cuda"][0],
              f"api {label}: K2 launched {case['block_matvec']} times")
        if dls1 == "inverse_pallas":
            check(case["fused_local_solve"] >= got["cuda"][0],
                  f"api {label}: K1 launched {case['fused_local_solve']} "
                  "times")
    return launches, shapes


def _read_back(path: str):
    """A PETSc binary dump as an array (Vec) or a CSR matrix (Mat)."""
    from geneo4petsc_tpu_torch.utils import petsc_format as pf

    with open(path, "rb") as f:
        classid = int(np.fromfile(f, ">i4", 1)[0])
    if classid == pf.VEC_FILE_CLASSID:
        return pf.read_vec_bin(path)
    check(classid == pf.MAT_FILE_CLASSID, f"{path}: classid {classid}")
    return pf.read_mat_bin(path)


def phase_chk_dbg() -> tuple[dict, list]:
    """-geneo_chk, -geneo_dbg log,2 and --debug bin on cpu and cuda, each
    run in a scratch directory of its own (see the docstring)."""
    import tempfile

    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    launches = {"fused_local_solve": 0, "block_matvec": 0}
    shapes = []
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        for label, args in CHK_DBG_ARGS.items():
            files = {}
            for dev in ("cpu", "cuda"):
                work = os.path.join(tmp, f"{label.replace(' ', '_')}-{dev}")
                os.makedirs(work)
                os.chdir(work)
                lk.fused_local_solve.launches = 0
                lk.block_matvec.launches = 0
                try:
                    _, info, out = _run_cli_keep(args + ["--device", dev])
                finally:
                    os.chdir(here)
                files[dev] = sorted(os.listdir(work))
                check(info["status"] == "converged",
                      f"chk-dbg {label} {dev}: {info}")
                if dev == "cuda":
                    case = {k: getattr(lk, k).launches for k in launches}
                    for k in launches:
                        launches[k] += case[k]
                    batch = out.assembled.batch
                    shapes.append(("chk-dbg", batch.n_dom, batch.n_max,
                                   str(batch.dtype)[6:], case))
                    bins = {f: _read_back(os.path.join(work, f))
                            for f in files[dev] if f.endswith(".bin")}
                    if "debug.output.X.bin" in bins:
                        x = bins["debug.output.X.bin"]
                        a = bins["debug.input.A.bin"]
                        b = bins["debug.input.B.bin"]
                        xt = np.loadtxt(os.path.join(work,
                                                     "debug.output.X.log"))
                        res = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
                        check(res <= 1e-4 and np.allclose(x, xt, rtol=1e-10),
                              f"chk-dbg {label}: binary dumps do not read "
                              f"back (|Ax-b|/|b| {res:.2e})")
            print(f"[chk-dbg] {label}: {len(files['cuda'])} files on cuda, "
                  f"{len(files['cpu'])} on cpu, equal sets "
                  f"{files['cuda'] == files['cpu']}; binaries read back: "
                  f"{[f for f in files['cuda'] if f.endswith('.bin')]}; "
                  f"cuda launches {case}", flush=True)
            check(files["cuda"] == files["cpu"],
                  f"chk-dbg {label}: cpu files {files['cpu']} != cuda "
                  f"{files['cuda']}")
            check(len(files["cuda"]) >= 5, f"chk-dbg {label}: too few files")
    return launches, shapes


def _elastic_parity_opts(lvl: str, eig: str):
    from geneo4petsc_tpu_torch.config import GenEOOptions

    o = GenEOOptions()
    o.lvl1, o.lvl2 = lvl.split(",")
    o.els2.type = eig
    o.dls1.rtol, o.dls1.max_it = 1e-11, 500
    return o


def phase_elastic_parity() -> None:
    import torch

    from geneo4petsc_tpu_torch.perf.lobpcg_start import jax_start
    from geneo4petsc_tpu_torch.structured.elastic import (elastic_grid,
                                                          solve_elastic)

    g = elastic_grid(**ELASTIC_PARITY_GRID)
    for (lvl, eig), want in ELASTIC_PARITY_JAX.items():
        got = {}
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            out = solve_elastic(
                g, ELASTIC_PARITY_DOMS, ELASTIC_PARITY_OVERLAP,
                _elastic_parity_opts(lvl, eig), tol=1e-8,
                dtype=torch.float64, device=dev, device_refine=False,
                lobpcg_start=jax_start)
            st = out.stats
            got[dev] = {
                "outer": out.refined.outer_its,
                "inner": out.refined.inner_its,
                "raw_dim_e": [int(v) for v in st.raw_dim_e],
                "real_dim_e": [int(v) for v in st.real_dim_e],
                "nicolaides": [int(v) for v in st.nicolaides],
                "e_pruned": int(st.e_pruned), "true_res": out.true_res,
                "s": time.perf_counter() - t0}
            if dev == "cuda":
                check(out.pc.z.device.type == "cuda",
                      f"elastic-parity {lvl}: the coarse basis is not on "
                      "the card")
        c = got["cuda"]
        print(f"[elastic-parity] {lvl} ({eig}): cuda {c['outer']} outer / "
              f"{c['inner']} inner, raw dim_e {c['raw_dim_e']}, real "
              f"{c['real_dim_e']}, nicolaides {sum(c['nicolaides'])}, "
              f"pruned {c['e_pruned']}, true_res {c['true_res']:.3e} "
              f"({c['s']:.2f} s); cpu {got['cpu']['outer']} / "
              f"{got['cpu']['inner']} ({got['cpu']['s']:.2f} s); JAX on the "
              f"CPU {want['outer']} / {want['inner']}, real "
              f"{want['real_dim_e']}, true_res {want['true_res']:.3e}",
              flush=True)
        keys = ("outer", "inner", "raw_dim_e", "nicolaides", "e_pruned")
        for dev in ("cuda", "cpu"):
            r = got[dev]
            check({k: r[k] for k in keys} == {k: want[k] for k in keys},
                  f"elastic-parity {lvl} {dev}: {r} != JAX {want}")
            # which column of an exactly dependent set the prune drops is
            # rounding: the per-domain split is held where nothing is
            # pruned, the total always
            check(sum(r["real_dim_e"]) == sum(want["real_dim_e"]) and (
                want["e_pruned"] or r["real_dim_e"] == want["real_dim_e"]),
                f"elastic-parity {lvl} {dev}: real dim_e {r['real_dim_e']}"
                f" != JAX {want['real_dim_e']}")
            check(r["true_res"] <= 1e-8,
                  f"elastic-parity {lvl} {dev}: true_res {r['true_res']}")


def phase_elastic() -> dict:
    """The 10.5M-DOF elasticity case (see the docstring)."""
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.structured.elastic import (elastic_grid,
                                                          solve_elastic)
    from geneo4petsc_tpu_torch.utils.timers import Timers

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    t0 = time.perf_counter()
    g = elastic_grid(ELASTIC_SIZE, kappa_max=1e4, interp="minmax",
                     spring=1e4)
    t_gen = time.perf_counter() - t0
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "E1"
    opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 60, 8
    opts.dls1.rtol, opts.dls1.max_it = 0.05, 40
    timers = Timers()
    t0 = time.perf_counter()
    # float32 inner iterations inside float64 refinement; the setup and
    # the global operator in float64 (solve_elastic's defaults on a card)
    out = solve_elastic(g, ELASTIC_DOMS, ELASTIC_OVERLAP, opts, tol=1e-8,
                        timers=timers, device="cuda", dtype=torch.float32,
                        setup_dtype=torch.float64)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    n = g.n_dof
    x = np.asarray(out.x, np.float64)
    err = float(np.max(np.abs(x - np.arange(1.0, n + 1)))) / n
    t0 = time.perf_counter()
    host_res = float(np.linalg.norm(out.b - g.matvec(x))
                     / np.linalg.norm(out.b))
    t_host = time.perf_counter() - t0
    st, tm = out.stats, timers.get
    info = {"n_dof": n, "dim_e": int(st.real_dim_e.sum()),
            "nicolaides": int(st.nicolaides.sum()),
            "e_pruned": int(st.e_pruned),
            "inner": out.refined.inner_its, "outer": out.refined.outer_its,
            "true_res": out.true_res, "host_res": host_res,
            "err_max_over_n": err, "peak_gb": peak_gb, "wall_s": wall,
            "generator_s": t_gen, "createA_s": tm("createA"),
            "l1_s": tm("l1_minv"), "lobpcg_s": tm("l2_eig"),
            "z_s": tm("l2_z"), "e_s": tm("l2_e"), "setup_s": tm("setup"),
            "solve_s": tm("solve"),
            "lobpcg_res_max": float(st.lobpcg_res.max())}
    print(f"[elastic] {n} DOF ({ELASTIC_SIZE}^3 nodes), 4x4x4 boxes of "
          f"{out.pc.local_shape} nodes, overlap {ELASTIC_OVERLAP}: dim_e "
          f"{info['dim_e']} (per domain {int(st.real_dim_e.min())}-"
          f"{int(st.real_dim_e.max())}, nicolaides {info['nicolaides']}, "
          f"pruned {info['e_pruned']}), {info['inner']} inner / "
          f"{info['outer']} outer iterations, true_res {out.true_res:.3e} "
          f"(host float64 recheck {host_res:.3e} in {t_host:.1f} s), max "
          f"|x - x_true| / n {err:.3e}, kept LOBPCG residual max "
          f"{info['lobpcg_res_max']:.3e}", flush=True)
    print(f"[elastic] phases: generator {t_gen:.3f} s, createA "
          f"{tm('createA'):.3f} s, L1 {tm('l1_minv'):.3f} s, LOBPCG "
          f"{tm('l2_eig'):.3f} s, Z {tm('l2_z'):.3f} s, E {tm('l2_e'):.3f} "
          f"s (setup {tm('setup'):.3f} s), solve {tm('solve'):.3f} s; "
          f"library wall {wall:.2f} s, peak device memory {peak_gb:.2f} GB, "
          f"refinement history {out.refined.history}", flush=True)
    check(out.converged and out.true_res <= 1e-8 and host_res <= 1e-8,
          f"elastic: not converged to 1e-8 (true_res {out.true_res}, host "
          f"{host_res})")
    check(bool(np.isfinite(x).all()), "elastic: non-finite solution")
    check(out.pc.z is not None and out.pc.z.device.type == "cuda"
          and out.pc.z.dtype == torch.float32
          and out.pc.gop.k0.dtype == torch.float64,
          "elastic: the float32 preconditioner (float64 operator) did not "
          "live on the card")
    check(launches == {"fused_local_solve": 0, "block_matvec": 0},
          f"elastic: K1/K2 launched on the elastic path: {launches}")
    check(peak_gb >= 1.0, f"elastic: peak device memory {peak_gb:.2f} GB")
    return info


def _ten_m_opts() -> tuple:
    """The 10M case's options as probes.timed_structured takes them."""
    return (TEN_M_GRID, TEN_M_DOMS, TEN_M_OVERLAP, "ASM,E1", 50, 2)


def phase_block_layout() -> dict:
    """The 10M case through solve_structured in the global and the block
    layout, in turns (global, block, block, global): equal coarse space,
    outer passes within 1, true residual <= 1e-8
    (tests/test_blockmode.py's contracts); TIME: total and the mean inner
    iteration by CUDA events of each run.  Returns each layout's second
    run, with its output and grid (phase roofline measures them)."""
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.parallel import probes

    got = {}
    for name in ("global", "block", "block", "global"):
        torch.cuda.empty_cache()
        lk.fused_local_solve.launches = lk.block_matvec.launches = 0
        got.pop(name, None)     # free this layout's earlier solve first
        got[name] = r = probes.timed_structured(
            *_ten_m_opts(), block_layout=name == "block", keep=True)
        print(f"[block-layout] {name} layout: {r['inner']} inner / "
              f"{r['outer']} outer, dim_e {r['dim_e']}, true_res "
              f"{r['true_res']:.3e}, max |x - x_true| / n "
              f"{r['err_max_over_n']:.3e}; TIME: total {r['wall_s']:.5f} s "
              f"(setup {r['phases']['setup']:.5f} s, solve "
              f"{r['phases']['solve']:.5f} s); inner solves "
              f"{r['inner_ms']:.3f} ms, {r['ms_per_inner_it']:.4f} ms an "
              f"inner iteration (CUDA events)", flush=True)
        check(lk.fused_local_solve.launches == 0
              and lk.block_matvec.launches == 0,
              f"block-layout {name}: K1/K2 launched")
        check(r["finite"] and r["true_res"] <= 1e-8,
              f"block-layout {name}: true residual {r['true_res']}")
    g, b = got["global"], got["block"]
    check(b["dim_e"] == g["dim_e"], f"block-layout dim_e {b['dim_e']} != "
                                    f"{g['dim_e']}")
    check(abs(b["outer"] - g["outer"]) <= 1,
          f"block-layout outer {b['outer']} vs {g['outer']}")
    return got


def phase_roofline(layouts: dict) -> None:
    """roofline.measure_structured on phase 15's two solves of the 10M
    case: the global layout's preconditioner, and the block layout's
    (blk=), with the setup's tau pencil, each solve's seconds and inner
    iterations, and a budget; nothing skipped and no share of a peak
    over ROOFLINE_MAX_SHARE.  Then the coarse replication wall's file."""
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions
    from geneo4petsc_tpu_torch.precond import geneo as pgeneo
    from geneo4petsc_tpu_torch.structured.blockmode import build_block_mode
    from geneo4petsc_tpu_torch.structured.decompose import (
        StructuredDecomposition)
    from geneo4petsc_tpu_torch.utils import roofline

    peaks = _peaks()
    print(roofline.smi_line(), flush=True)
    g, b = layouts["global"], layouts["block"]
    _grid, doms, overlap, _lvl, _its, cut = _ten_m_opts()
    sd = StructuredDecomposition(g["grid"], doms, overlap)
    dev = g["out"].pc.maskf.device
    # the setup's default tau (the 10M case sets none)
    pencils = roofline.tau_pencils(sd, GenEOOptions().tau, cut,
                                   torch.float32, dev)
    blk = build_block_mode(b["out"].pc, sd, torch.float32, dev)
    for name, r, block in (("global", g, None), ("block", b, blk)):
        t0 = time.perf_counter()
        rec = roofline.measure_structured(
            r["out"].pc, pencils=pencils, solve_s=r["phases"]["solve"],
            inner_its=r["inner"], budget_s=ROOFLINE_BUDGET_S, blk=block)
        wall = time.perf_counter() - t0
        print(json.dumps({"roofline": name, "measure_s": wall, **rec}),
              flush=True)
        check(rec.get("device_kind") == peaks["kind"]
              and "hbm_peak_gbps" in rec,
              f"roofline {name}: no peaks in the record")
        check("skipped" not in rec, f"roofline {name}: skipped "
                                    f"{rec.get('skipped')} within "
                                    f"{ROOFLINE_BUDGET_S} s")
        want = {"stencil_matvec", "fdm_apply", "pc_apply", "lobpcg_step",
                "solve_phase"}
        check(want <= set(rec), f"roofline {name}: missing "
                                f"{sorted(want - set(rec))}")
        for entry, e in rec.items():
            for key, share in (e.items() if isinstance(e, dict) else ()):
                if key.startswith("frac_of_"):
                    check(0.0 < share <= ROOFLINE_MAX_SHARE,
                          f"roofline {name}: {entry} {key} {share}")
    del pencils, blk
    torch.cuda.empty_cache()

    check(os.path.exists(pgeneo.COARSE_SCALING),
          f"{pgeneo.COARSE_SCALING} is missing")
    with open(pgeneo.COARSE_SCALING) as f:
        rec = json.load(f)
    wall = pgeneo.coarse_replication_wall()
    host = rec["host"]
    print(f"[roofline] coarse replication wall dim_e {wall} "
          f"({os.path.relpath(pgeneo.COARSE_SCALING, HERE)}: {rec['card']},"
          f" {rec['power_limit']}; host {host['cpu_model']}, "
          f"{host['threads']} threads; dims "
          f"{[r['dim_e'] for r in rec['rows']]})", flush=True)
    check("NVIDIA" in rec["card"] and wall == rec["replication_wall_dim_e"],
          f"coarse_scaling.json: card {rec['card']}, wall {wall}")


def phase_nccl_structured(single: dict) -> dict:
    """The 10M case with n_devices=1: one spawned rank in a world-size-1
    NCCL group (z-slab plan, plane exchanges, all_reduce inner products);
    counts equal to the single-device route's in this run."""
    import torch

    from geneo4petsc_tpu_torch.parallel import multiproc, probes

    torch.cuda.empty_cache()
    r = multiproc.run_ranks(probes.timed_structured, 1, args=(
        *_ten_m_opts(), False, 1, "cuda"), device="cuda", timeout=600)
    print(f"[nccl-structured] 1 NCCL rank: {r['inner']} inner / "
          f"{r['outer']} outer, dim_e {r['dim_e']}, true_res "
          f"{r['true_res']:.3e}; TIME: total {r['wall_s']:.5f} s; "
          f"{r['ms_per_inner_it']:.4f} ms an inner iteration against "
          f"{single['ms_per_inner_it']:.4f} ms on the single-device route "
          f"(CUDA events)", flush=True)
    check(r["finite"] and r["true_res"] <= 1e-8,
          f"nccl-structured true residual {r['true_res']}")
    counts = (r["inner"], r["outer"], r["dim_e"])
    want = (single["inner"], single["outer"], single["dim_e"])
    check(counts == want, f"nccl-structured counts {counts} != "
                          f"single-device {want}")
    return r


def _generic_multi_args(lvl: str) -> list:
    return ["--inpLibA", "laplacian",
            "--inpLibArg", "--size 12#--dim 2#--kappa 100. minmax",
            "--nbPart", "6", "--addOverlap", "1", "-ksp_rtol", "1e-8",
            "-pc_type", "geneo", "-geneo_lvl", lvl]


def phase_nccl_generic() -> tuple[dict, list]:
    """JAX's GENERIC_CONFIGS and one -dls1_type inverse_pallas case
    through the CLI with --nbDevices 1 on cuda, in a world-size-1 NCCL
    group of this process (the mpirun-style path: the CLI runs as rank 0
    of the group it finds): iterations equal to the same CLI runs
    without --nbDevices; K1/K2 launched on the rank's chunk."""
    import tempfile

    import torch.distributed as dist

    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.parallel import multiproc

    cases = [(lvl, []) for lvl, *_ in MULTI_GENERIC] + [
        ("ASM,1", ["-dls1_type", "inverse_pallas"])]
    single = {}
    for lvl, extra in cases:
        _, info = _run_cli(_generic_multi_args(lvl) + extra
                           + ["--device", "cuda"])
        single[lvl, tuple(extra)] = info["its"]
    store = tempfile.mkdtemp(prefix="nccl_generic_")
    multiproc.join_group(f"file://{store}/store", 0, 1, "cuda")
    lk.fused_local_solve.launches = lk.block_matvec.launches = 0
    shapes = []
    try:
        for lvl, extra in cases:
            before = (lk.fused_local_solve.launches,
                      lk.block_matvec.launches)
            log, info, out = _run_cli_keep(
                _generic_multi_args(lvl) + extra
                + ["--device", "cuda", "--nbDevices", "1"])
            batch = out.assembled.batch
            launches = {
                "fused_local_solve": lk.fused_local_solve.launches
                - before[0], "block_matvec": lk.block_matvec.launches
                - before[1]}
            shapes.append(("nccl-generic", batch.n_dom, batch.n_max,
                           str(batch.dtype)[6:], launches))
            want = single[lvl, tuple(extra)]
            print(f"[nccl-generic] {lvl} {' '.join(extra)}: --nbDevices 1 "
                  f"{info['its']} its {info['reason']} (without: {want}), "
                  f"true_res {info['true_res']:.3e}; chunk [{batch.n_dom},"
                  f" {batch.n_max}, {batch.n_max}] launches {launches}",
                  flush=True)
            check("nb devices 1" in log, f"nccl-generic {lvl}: no mode")
            check(info["status"] == "converged" and info["its"] == want,
                  f"nccl-generic {lvl}: {info['its']} its != {want}")
    finally:
        dist.destroy_process_group()
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    check(launches["fused_local_solve"] > 0 and launches["block_matvec"] > 0,
          f"nccl-generic: K1/K2 not launched {launches}")
    return launches, shapes


def phase_nccl_elastic() -> dict:
    """elastic-parity's ASM,1 case with n_devices=1: one spawned NCCL
    rank; counts equal to that phase's JAX constants."""
    import torch

    from geneo4petsc_tpu_torch.structured.elastic import (elastic_grid,
                                                          solve_elastic)

    want = ELASTIC_PARITY_JAX["ASM,1", "eigh"]
    t0 = time.perf_counter()
    out = solve_elastic(elastic_grid(**ELASTIC_PARITY_GRID),
                        ELASTIC_PARITY_DOMS, ELASTIC_PARITY_OVERLAP,
                        _elastic_parity_opts("ASM,1", "eigh"), tol=1e-8,
                        dtype=torch.float64, device="cuda",
                        device_refine=False, n_devices=1)
    got = dict(outer=out.refined.outer_its, inner=out.refined.inner_its,
               real_dim_e=[int(v) for v in out.stats.real_dim_e],
               true_res=out.true_res, s=time.perf_counter() - t0)
    print(f"[nccl-elastic] ASM,1 on 1 NCCL rank: {got['outer']} outer / "
          f"{got['inner']} inner, real dim_e {got['real_dim_e']}, true_res "
          f"{got['true_res']:.3e} ({got['s']:.2f} s); JAX on the CPU "
          f"{want['outer']} / {want['inner']}", flush=True)
    check((got["outer"], got["inner"], got["real_dim_e"])
          == (want["outer"], want["inner"], want["real_dim_e"]),
          f"nccl-elastic counts {got} != JAX {want}")
    check(got["true_res"] <= 1e-8, f"nccl-elastic true_res {got}")
    return got


def phase_multi_rank_cpu() -> None:
    """gloo ranks on the host's CPU through the CLI (--device cpu): the
    generic configurations on 4 and 8 ranks against the JAX package's
    counts exactly, the structured ones on 8, 4 and 2 within
    MULTI_FLOOR_BAND (coarse dimension and outer passes exact) and with
    a float64 inner CG exactly, the elastic case on 8 exactly; every true
    residual <= 1e-8."""
    _re_dim = re.compile(r"real dimE (\d+)")
    for lvl, ndev, its, dim_e in MULTI_GENERIC:
        t0 = time.perf_counter()
        log, info = _run_cli(_generic_multi_args(lvl)
                             + ["--device", "cpu", "--nbDevices", str(ndev)])
        print(f"[multi-rank-cpu] generic {lvl} on {ndev} gloo ranks: "
              f"{info['its']} its (JAX {its}), dim_e {info.get('dim_e')} "
              f"(JAX {dim_e}), true_res {info['true_res']:.3e}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(info["status"] == "converged"
              and (info["its"], info.get("dim_e")) == (its, dim_e),
              f"multi-rank-cpu generic {lvl}: {info}")
    cases = [(wl, lvl, ndev, its, dim_e, outer, MULTI_FLOOR_BAND,
              ["--inpLibA", wl, "--inpLibArg",
               "--size 16#--dim 3#--kappa 100. minmax", "-geneo_lvl", lvl])
             for wl, lvl, ndev, its, dim_e, outer in MULTI_STRUCTURED]
    ndev, its, dim_e, outer = MULTI_ELASTIC
    cases.append(("elasticity", "RAS,1", ndev, its, dim_e, outer, 0, [
        "--inpLibA", "elasticity", "--inpLibArg",
        "--size 8#--kappa 100. minmax#--spring 100.", "-geneo_lvl", "RAS,1",
        "-geneo_cut", "8"]))
    for wl, lvl, ndev, its, dim_e, outer, band, args in cases:
        from geneo4petsc_tpu_torch import cli
        buf = io.StringIO()
        t0 = time.perf_counter()
        rc = cli.run(args + ["--structured", "2,2,2", "--addOverlap", "1",
                             "-pc_type", "geneo", "-ksp_type", "cg",
                             "-ksp_rtol", "1e-8", "--device", "cpu",
                             "--nbDevices", str(ndev)], out=buf)
        log = buf.getvalue()
        m, md = _RE_REFINED.search(log), _re_dim.search(log)
        check(rc == 0 and m is not None and md is not None,
              f"multi-rank-cpu {wl} {lvl}: rc {rc}\n{log}")
        got = (int(m.group(3)), int(md.group(1)), int(m.group(2)))
        print(f"[multi-rank-cpu] {wl} {lvl} on {ndev} gloo ranks: {got[0]} "
              f"inner / {got[2]} outer, dim_e {got[1]} (JAX {its} / {outer}"
              f", {dim_e}), true_res {float(m.group(4)):.3e}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(m.group(1) == "converged" and float(m.group(4)) <= 1e-8,
              f"multi-rank-cpu {wl} {lvl}: {m.group(0)}")
        check(abs(got[0] - its) <= band and got[1] == dim_e
              and abs(got[2] - outer) <= (1 if band else 0),
              f"multi-rank-cpu {wl} {lvl}: {got} vs JAX {(its, dim_e, outer)}")
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.structured import grid as sgrid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured
    for wl, lvl, ndev, _its, _dim_e, _outer in MULTI_STRUCTURED:
        want = MULTI_FLOAT64[(wl, lvl)]
        opts = GenEOOptions()
        opts.lvl1, opts.lvl2 = lvl.split(",")
        t0 = time.perf_counter()
        out = solve_structured(
            getattr(sgrid, f"{wl}_grid")(16, dim=3, kappa_max=100.0,
                                         interp="minmax"), (2, 2, 2), 1,
            geneo=opts, ksp=KSPOptions(type="cg", rtol=1e-8),
            dtype=torch.float64, device="cpu", n_devices=ndev)
        got = (out.refined.inner_its, out.refined.outer_its,
               int(out.stats.real_dim_e.sum()))
        print(f"[multi-rank-cpu] {wl} {lvl} float64 inner on {ndev} gloo "
              f"ranks: {got[0]} inner / {got[1]} outer, dim_e {got[2]} "
              f"(JAX {want[0]} / {want[1]}, {want[2]}), true_res "
              f"{out.true_res:.3e}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(got == want and out.true_res <= 1e-8,
              f"multi-rank-cpu {wl} {lvl} float64: {got} vs JAX {want}, "
              f"true_res {out.true_res}")


def main() -> int:
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    try:
        import geneo4petsc_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: geneo4petsc_tpu_torch not found next to this "
              "script; run it from the repository root", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernels()
    phase_small()
    by_phase = {}
    by_phase["slice"], slice_shape, slice_info = phase_slice()
    phase_structured_parity()
    by_phase["battery"] = phase_battery()
    phase_structured()
    by_phase["nonsep"] = phase_nonsep()["launches"]
    large = phase_large(slice_info)
    by_phase["large"] = large["launches"]
    by_phase["generic-family"], family_shapes = phase_generic_family()
    by_phase["api"], api_shapes = phase_api()
    by_phase["chk-dbg"], chk_shapes = phase_chk_dbg()
    phase_elastic_parity()
    phase_elastic()
    layouts = phase_block_layout()
    phase_roofline(layouts)
    for r in layouts.values():
        del r["out"], r["grid"]
    phase_nccl_structured(layouts["global"])
    by_phase["nccl-generic"], nccl_shapes = phase_nccl_generic()
    phase_nccl_elastic()
    phase_multi_rank_cpu()
    at_shapes = phase_path_shapes([slice_shape, large["shape"],
                                   *family_shapes, *api_shapes,
                                   *chk_shapes, *nccl_shapes])

    sources = {"fused_local_solve": ("geneo4petsc_tpu_torch/csrc/"
                                     "fused_local_solve.cu",
                                     "geneo4petsc_tpu/ops/pallas_kernels.py:90"),
               "block_matvec": ("geneo4petsc_tpu_torch/csrc/block_matvec.cu",
                                "geneo4petsc_tpu/ops/pallas_kernels.py:125")}
    # launches: the sum over the phases that drive a main path with K1/K2
    # (slice, large, generic-family, api, chk-dbg, nccl-generic) and the
    # battery's and nonsep's zeros (the structured and elastic paths have
    # none either); the
    # times and error at the slice's shape, and in "shapes" at every
    # shape a main path gave the kernel
    rows = []
    for name, (src, rep) in sources.items():
        at_slice = next(r for r in at_shapes[name] if "slice" in r["phases"])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": sum(c[name] for c in by_phase.values()),
                     "launches_by_phase": {p: c[name]
                                           for p, c in by_phase.items()},
                     **{k: v for k, v in at_slice.items()
                        if k not in ("phases", "shape", "dtype")},
                     "shapes": at_shapes[name]})
    print(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
          "included", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
