"""Where the elastic path's time goes on the card.

    python -m geneo4petsc_tpu_torch.perf.elastic_profile [--size 152]
        [--doms 4] [--overlap 2] [--solves 2] [--precisions]
        [--device cuda]

Builds the JAX package's 10.5M-DOF elasticity bench case (bench.py:491-
545: elastic_grid(152, kappa_max=1e4, interp="minmax", spring=1e4), 4x4x4
boxes, overlap 2, ASM,E1 with LOBPCG cut 8, 60 iterations, level-1 PCG
rtol 0.05 at most 40 iterations), then

1. times the host phases (the grid, the decomposition) and the setup
   (setup_elastic in float64, as solve_elastic runs it on a card);
2. repeats one inner solve (the first correction of the refinement,
   rtol 1e-5: float32 flexible CG, the float32 preconditioner, the
   float64 global operator) ``--solves`` times: ms per inner iteration;
3. times single calls with CUDA events, each beside its bound — the
   bytes it must move (each input read once, each output written once)
   or its operations, whichever bounds it (roofline.bound_ms): the
   global cell sum (float64
   and float32), the dilated Dirichlet cell sum of one vector and of the
   LOBPCG block (3k columns, float64, on one domain chunk of
   setup_elastic's byte budget), the halo gather and scatter of a
   displacement vector, the surrogate FDM solve, one level-1 PCG solve,
   apply_q, the preconditioner apply, and one LOBPCG iteration of the
   block of cut 8 on one domain chunk (float64; on (A_Dir, D A_Dir D)
   with the level-1 surrogate: the tau pencil's work but for its
   Neumann side's one-layer-smaller window);
4. with ``--precisions``: the whole solve_elastic three ways — the JAX
   package's float32 setup and operator, the float64 setup and operator
   with float32 inner iterations (solve_elastic's default on a card),
   and float64 throughout — with their iterations, residuals and phase
   times.

Every time is a reading of this run on this card, whose name and power
limit are printed first.  ``--device cpu`` runs steps 1-2 only, for a
rehearsal at a small ``--size``.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from ..config import GenEOOptions
from ..ops.lobpcg import default_start, matfree_lobpcg
from ..structured import elastic as el
from ..utils import roofline
from ..utils.cuda_timing import time_ms
from ..utils.timers import Timers

CELL_FLOPS = 2 * 24 * 24 + 2 * 24   # K0 product, weight, corner adds


def _options() -> GenEOOptions:
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "ASM", "E1"
    o.els2.type, o.els2.max_it, o.cut = "lobpcg", 60, 8
    o.dls1.rtol, o.dls1.max_it = 0.05, 40
    return o


def _precisions(g, doms, overlap, dev) -> None:
    variants = (("JAX's: float32 setup and operator", torch.float32,
                 torch.float32),
                ("float64 setup and operator, float32 inner", torch.float64,
                 torch.float32),
                ("float64 throughout", torch.float64, torch.float64))
    for label, setup_dtype, dtype in variants:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timers = Timers()
        t0 = time.perf_counter()
        out = el.solve_elastic(g, (doms,) * 3, overlap, _options(),
                               tol=1e-8, timers=timers, device=dev,
                               dtype=dtype, setup_dtype=setup_dtype)
        wall = time.perf_counter() - t0
        st = out.stats
        print(f"[precision] {label}: converged {out.converged}, "
              f"{out.refined.outer_its} outer / {out.refined.inner_its} "
              f"inner, true_res {out.true_res:.3e}, dim_e "
              f"{int(st.real_dim_e.sum())} (pruned {st.e_pruned}), kept "
              f"LOBPCG residual max {float(st.lobpcg_res.max()):.3e}; "
              f"wall {wall:.2f} s (setup {timers.get('setup'):.2f} s, "
              f"LOBPCG {timers.get('l2_eig'):.2f} s, solve "
              f"{timers.get('solve'):.2f} s), peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"history {[f'{h:.2e}' for h in out.refined.history]}",
              flush=True)
        del out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=152)
    ap.add_argument("--doms", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--solves", type=int, default=2)
    ap.add_argument("--precisions", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        peaks = roofline.device_peaks(dev)
        if peaks is None:
            print("elastic_profile: no CUDA card the peaks table knows",
                  file=sys.stderr)
            return 1
        print(roofline.smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- 1. host phases and the setup ----
    t0 = time.perf_counter()
    g = el.elastic_grid(args.size, kappa_max=1e4, interp="minmax",
                        spring=1e4)
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = el._geom(g, (args.doms,) * 3, args.overlap)
    t_sd = time.perf_counter() - t0
    opts = _options()
    op64 = el.elastic_op(g, torch.float64, dev)
    b = op64.matvec(torch.arange(1, g.n_dof + 1, dtype=torch.float64,
                                 device=dev))
    timers = Timers()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pc64, stats = el.setup_elastic(g, (args.doms,) * 3, args.overlap, opts,
                                   b=b, dtype=torch.float64, timers=timers,
                                   device=dev)
    sync()
    t_setup = time.perf_counter() - t0
    pc = el.cast_tree(pc64, torch.float32)
    pc = dataclasses.replace(pc, gop=op64)
    n, n_dom = g.n_dof, sd.n_dom
    sx, sy, sz = sd.local_shape
    n_loc = sx * sy * sz
    print(f"[host] {n} DOF, {n_dom} boxes of {sd.local_shape} nodes: "
          f"elastic_grid {t_grid:.3f} s, decomposition {t_sd:.4f} s",
          flush=True)
    print(f"[setup] setup_elastic (float64) {t_setup:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timers.phases.items()))
          + f"; dim_e {int(stats.real_dim_e.sum())}, k_max {pc.k_max}"
          + (f", peak device memory "
             f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
             if on_card else ""), flush=True)

    # ---- 2. the inner solve ----
    inner = el.make_elastic_inner(pc)
    s = 2.0 ** torch.ceil(torch.log2(b.abs().max()))
    r32 = (b / s).float()

    def solve():
        res = inner(r32, 1e-5)
        sync()
        return res

    solve()
    per_it = []
    for _ in range(args.solves):
        t0 = time.perf_counter()
        res = solve()
        per_it.append((time.perf_counter() - t0) / max(res.its, 1) * 1e3)
    print(f"[solve] inner flexible CG to 1e-5: {res.its} iterations, "
          f"reason {res.reason}; ms per iteration over {len(per_it)} "
          f"solves: median {statistics.median(per_it):.4f}, least "
          f"{min(per_it):.4f}, most {max(per_it):.4f}", flush=True)
    if not on_card:
        return 0

    # ---- 3. single calls beside their bounds ----
    f4, f8 = 4, 8
    cells = (g.shape[0] - 1) ** 3
    wz, wy, wx = (v + 2 for v in (sz, sy, sx))         # dilated window
    dil_cells = (wz - 1) * (wy - 1) * (wx - 1)
    k = pc.k_max
    kc = 3 * opts.cut
    # the LOBPCG runs on domain chunks within setup_elastic's byte budget
    chunk = int(np.clip(el.BUDGET_BYTES // (kc * el._block_bytes(
        sd.local_shape, True, 8)), 1, n_dom))
    x64 = r32.double()
    op32 = el.elastic_op(g, torch.float32, dev)
    xb = pc._gather(r32)
    dir64 = pc64.l1.st
    dir64c = el._domains(dir64, 0, chunk)
    xb64 = xb.double()
    blk64 = torch.randn((chunk, kc, 3, sz, sy, sx), dtype=torch.float64,
                        device=dev)
    loc = n_dom * 3 * n_loc
    lsq = sz + sy + sx
    calls = [
        ("global cell sum (float64)", lambda: op64.matvec(x64), torch.float64,
         (2 * n + cells + n // 3) * f8, CELL_FLOPS * cells),
        ("global cell sum (float32)", lambda: op32.matvec(r32),
         torch.float32, (2 * n + cells + n // 3) * f4, CELL_FLOPS * cells),
        ("dilated Dirichlet cell sum, 1 vector (float64)",
         lambda: dir64.matvec(xb64), torch.float64,
         (2 * loc + n_dom * (dil_cells + wz * wy * wx)) * f8,
         CELL_FLOPS * n_dom * dil_cells),
        (f"dilated Dirichlet cell sum, block of {kc}, {chunk} domains "
         "(float64)", lambda: dir64c.matvec(blk64), torch.float64,
         (2 * kc * loc + n_dom * (dil_cells + wz * wy * wx)) * f8
         * chunk / n_dom, CELL_FLOPS * chunk * dil_cells * kc),
        ("halo gather", lambda: pc._gather(r32), torch.float32,
         (n + loc) * f4, 0.0),
        ("halo scatter", lambda: pc._scatter(xb), torch.float32,
         (n + loc) * f4, 0.0),
        ("surrogate FDM solve (3 components)", lambda: pc.l1.pre.solve(xb),
         torch.float32, 4 * loc * f4, 2 * 2 * lsq * loc),
        ("level-1 PCG solve", lambda: pc.l1.solve(xb), torch.float32,
         2 * loc * f4, 0.0),
        ("apply_q", lambda: pc.apply_q(r32), torch.float32,
         (2 * n + k * loc) * f4, 4 * k * loc),
        ("pc.apply", lambda: pc.apply(r32), torch.float32,
         (2 * n + k * loc) * f4, 0.0),
    ]
    for name, fn, dtype, n_bytes, flops in calls:
        for _ in range(2):
            fn()
        ts = [time_ms(fn, 3) for _ in range(5)]
        bound, by = roofline.bound_ms(n_bytes, flops, dtype, peaks)
        med = statistics.median(ts)
        print(f"[call] {name}: {med:.4f} ms [{min(ts):.4f}, {max(ts):.4f}]"
              f"; bound {bound:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), share of bound "
              f"{bound / med:.3f}", flush=True)

    # one LOBPCG iteration (float64, cut 8) on (A_Dir, D A_Dir D) with
    # the level-1 surrogate as preconditioner: the tau pencil's work,
    # but for its Neumann side's one-layer-smaller window
    dir_wrap = dir64c
    b_dad = el.PouSandwich(op=dir_wrap, d=pc64.pou[:chunk])
    pre = el._domains(pc64.l1.pre, 0, chunk)
    box = (3, sz, sy, sx)
    maskc = pc64.maskf[:chunk].unsqueeze(1).expand(chunk, 3, sz, sy, sx) \
        .reshape(chunk, 1, -1)

    def op(o):
        return lambda v: o.matvec(v.reshape((chunk, -1) + box)).reshape(
            chunk, -1, 3 * n_loc)

    def t_op(v):
        return pre.solve(v.reshape((chunk, -1) + box)).reshape(
            chunk, -1, 3 * n_loc) * maskc

    x0 = default_start(chunk, 3 * n_loc, opts.cut, torch.float64).to(dev)
    x0 = t_op(x0.transpose(1, 2) * maskc)

    def lobpcg(its):
        return lambda: matfree_lobpcg(op(dir_wrap), op(b_dad), t_op, x0,
                                      max_it=its, tol=0.0)

    runs = {}
    for its in (1, 6, 1, 6):
        runs.setdefault(its, []).append(time_ms(lobpcg(its), 1))
    step = (statistics.median(runs[6]) - statistics.median(runs[1])) / 5
    # a step: ~4 cell sums of 3k columns on the dilated windows (A and B
    # of X and of the search block), a surrogate FDM solve of k columns,
    # the Gram matrices of the 3k block
    loc_c = chunk * 3 * n_loc
    lob_bytes = (4 * kc + 10) * loc_c * f8
    lob_flops = (4 * kc * CELL_FLOPS * dil_cells * chunk
                 + 4 * lsq * opts.cut * loc_c + 8 * kc * kc * loc_c)
    bound, by = roofline.bound_ms(lob_bytes, lob_flops, torch.float64,
                                  peaks)
    print(f"[call] LOBPCG iteration (float64, k={opts.cut}, one chunk of "
          f"{chunk} domains): "
          f"{step:.4f} ms (6 iterations {statistics.median(runs[6]):.3f} "
          f"ms, 1 {statistics.median(runs[1]):.3f} ms); bound {bound:.4f} "
          f"ms by {by} ({lob_bytes / 1e6:.1f} MB, {lob_flops / 1e9:.2f} "
          f"GFLOP), share of bound {bound / step:.3f}", flush=True)
    del pc, pc64, x0, blk64, dir64c, pre
    torch.cuda.empty_cache()

    # ---- 4. the three precisions, end to end ----
    if args.precisions:
        _precisions(g, args.doms, args.overlap, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
