"""Where the structured path's time goes on the card.

    python -m geneo4petsc_tpu_torch.perf.structured_profile [--size 216]
        [--doms 4] [--overlap 2] [--solves 3] [--device cuda]

Builds the repository's structured case (laplacian --size 216 --dim 3
--kappa 10000. minmax: 10,077,696 DOF; 4x4x4 boxes, overlap 2; ASM,E1
with LOBPCG cut 2, 50 iterations; float32 preconditioner), then

1. times the host phases one by one: the grid, the decomposition, the
   1-D FDM eigendecompositions (Dirichlet and shifted Neumann), and the
   whole preconditioner set-up (setup_structured);
2. repeats one float32 inner CG solve (the first correction of the
   refinement, rtol 1e-5) ``--solves`` times: ms per inner iteration;
3. times single calls with CUDA events — halo_gather, halo_scatter_add,
   LocalStencil.matvec (one vector and the LOBPCG block of 3k), the
   global stencil, FDMFactor.solve, apply_q, the preconditioner apply
   and one LOBPCG iteration of the tau pencil — each beside its bound:
   roofline.bound_ms of the bytes it must move (each input read once,
   each output written once) and its float32 operations (the models of
   the matvec, the FDM solve, the apply and the LOBPCG step are
   utils/roofline.py's, which measure_structured uses);
4. traces one inner solve with torch.profiler: kernel time by name,
   kernel launches per iteration, and the card's busy and idle share.

Every time is a reading of this run on this card, whose name and power
limit are printed first.  ``--device cpu`` runs steps 1-2 only, for a
rehearsal at a small ``--size``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..config import GenEOOptions
from ..structured import fdm, halo
from ..structured.decompose import StructuredDecomposition
from ..structured.geneo import setup_structured
from ..structured.grid import global_stencil, laplacian_grid
from ..structured.solve import make_structured_inner
from ..utils import roofline
from ..utils.cuda_timing import time_ms
from ..utils.timers import Timers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=216)
    ap.add_argument("--doms", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        peaks = roofline.device_peaks(dev)
        if peaks is None:
            print("structured_profile: no CUDA card the peaks table knows",
                  file=sys.stderr)
            return 1
        print(roofline.smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- 1. host phases ----
    t0 = time.perf_counter()
    grid = laplacian_grid(args.size, dim=3, kappa_max=10000.0,
                          interp="minmax")
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = StructuredDecomposition(grid, (args.doms,) * 3, args.overlap)
    t_sd = time.perf_counter() - t0
    t0 = time.perf_counter()
    fdm.fdm_factor(fdm.dirichlet_axes(sd), device=dev)
    fdm.fdm_factor(fdm.neumann_axes(sd), shift=0.1, device=dev)
    sync()
    t_fdm = time.perf_counter() - t0
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "E1"
    opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 50, 2
    gop64 = global_stencil(grid, torch.float64, dev)
    b = gop64.matvec(torch.arange(1, grid.n_nodes + 1, dtype=torch.float64,
                                  device=dev))
    timers = Timers()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pc, stats = setup_structured(sd, opts, b=b.float(), dtype=torch.float32,
                                 timers=timers, device=dev)
    sync()
    t_setup = time.perf_counter() - t0
    n, n_dom, n_loc = grid.n_nodes, sd.n_dom, int(np.prod(sd.local_shape))
    print(f"[host] {n} DOF, {n_dom} boxes of {sd.local_shape} ({n_loc} "
          f"points): laplacian_grid {t_grid:.3f} s, decomposition "
          f"{t_sd:.4f} s, FDM factors (host eigh + upload, both) "
          f"{t_fdm:.3f} s", flush=True)
    print(f"[setup] setup_structured {t_setup:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timers.phases.items()))
          + f"; dim_e {int(stats.real_dim_e.sum())}, k_max {pc.k_max}"
          + (f", peak device memory "
             f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
             if on_card else ""), flush=True)

    # ---- 2. the inner solve ----
    inner = make_structured_inner(pc)
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
        per_it.append((time.perf_counter() - t0) / res.its * 1e3)
    print(f"[solve] inner CG to 1e-5: {res.its} iterations, reason "
          f"{res.reason}; ms per iteration over {len(per_it)} solves: "
          f"median {statistics.median(per_it):.4f}, least "
          f"{min(per_it):.4f}, most {max(per_it):.4f}", flush=True)
    if not on_card:
        return 0

    # ---- 3. single calls beside their bounds ----
    f4 = 4
    k = pc.k_max
    x = r32.clone()
    xb = halo.to_batch(halo.halo_gather(x, pc.grid_shape, pc.dom_grid,
                                        pc.pad))
    yb = xb.clone()
    neu, b_dad, maskf, t1, kc = roofline.tau_pencils(
        sd, opts.tau, opts.cut, torch.float32, dev)
    blk = torch.randn((n_dom, 3 * kc) + tuple(maskf.shape[1:]), device=dev)
    loc = n_dom * n_loc
    lsq = sum(sd.local_shape)
    calls = [
        ("halo_gather", lambda: halo.halo_gather(
            x, pc.grid_shape, pc.dom_grid, pc.pad), (n + loc) * f4, 0.0),
        ("halo_scatter_add", lambda: halo.halo_scatter_add(
            halo.from_batch(yb, pc.dom_grid), pc.grid_shape, pc.dom_grid,
            pc.pad), (n + loc) * f4, 0.0),
        ("GlobalStencil.matvec", lambda: pc.gop.matvec(x),
         *roofline.stencil_model(n, f4)),
        ("LocalStencil.matvec", lambda: neu.matvec(xb), 6 * loc * f4,
         7 * 2 * loc),
        (f"LocalStencil.matvec [d,{3 * kc},...]", lambda: neu.matvec(blk),
         (4 + 2 * 3 * kc) * loc * f4, 7 * 2 * loc * 3 * kc),
        ("FDMFactor.solve", lambda: pc.l1.solve(xb),
         *roofline.fdm_model(loc, lsq, f4)),
        ("apply_q", lambda: pc.apply_q(x), (2 * n + k * loc) * f4,
         4 * k * loc),
        ("pc.apply", lambda: pc.apply(x),
         *roofline.pc_apply_model(pc, n, loc, lsq, f4)),
    ]
    for name, fn, n_bytes, flops in calls:
        for _ in range(3):
            fn()
        ts = [time_ms(fn, 10) for _ in range(5)]
        bound, by = roofline.bound_ms(n_bytes, flops, torch.float32, peaks)
        med = statistics.median(ts)
        print(f"[call] {name}: {med:.4f} ms [{min(ts):.4f}, {max(ts):.4f}]"
              f"; bound {bound:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), share of bound "
              f"{bound / med:.3f}", flush=True)

    # one LOBPCG iteration of the tau pencil at the setup's block size
    e = roofline.lobpcg_step((neu, b_dad, maskf, t1, kc), peaks)
    print(f"[call] LOBPCG iteration (tau pencil, k={kc}): "
          f"{e['time_ms']:.4f} ms (1 and 11 iterations differenced); bound "
          f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bytes'] / 1e6:.1f}"
          f" MB, {e['flops'] / 1e9:.2f} GFLOP), share of bound "
          f"{e['bound_ms'] / e['time_ms']:.3f}", flush=True)

    # ---- 4. profiler trace of one inner solve ----
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("[trace] the profiler recorded no device time", flush=True)
        return 1
    for key, ms, count in rows[:15]:
        print(f"[trace] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<6d} "
              f"{key[:90]}", flush=True)
    launches = sum(r[2] for r in rows)
    print(f"[trace] one inner solve of {res.its} iterations under the "
          f"profiler: wall {wall_ms:.3f} ms, kernel time {busy:.3f} ms, "
          f"{launches} kernel launches ({launches / res.its:.1f} per "
          f"iteration), busy share {busy / wall_ms:.3f}, idle share "
          f"{1 - busy / wall_ms:.3f}; kernel time over the unprofiled "
          f"median wall {busy / (statistics.median(per_it) * res.its):.3f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
