"""Where one Krylov iteration of the slice spends its time on the card.

    python -m geneo4petsc_tpu_torch.perf.iteration_profile [--size 512]
        [--nb-part 1024] [--solves 5] [--parent DIR]

Sets the slice up once (laplacian --size 512 --dim 2 --kappa 10000.
minmax, 1024 subdomains, overlap 1, dual partitioning, ASM,E1 with
precomputed inverses, CG to 1e-8 — the configuration chip_smoke.py
drives), then

1. repeats the CG solve ``--solves`` times and prints the median wall
   time per iteration (host clock around a synchronised solve); with
   ``--parent DIR`` (a checkout of an earlier commit) it repeats them
   with that commit's K1 and K2 in their place, in turns (this tree,
   parent, parent, this tree), on the same set-up problem;
2. times single calls with CUDA events: K1, K2, gather, scatter-add,
   apply_q, the preconditioner apply, the operator product;
3. traces one solve with torch.profiler and prints the kernel time by
   name and the card's busy and idle share of that solve's wall time.

Every line is a reading of this run on this card, whose name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from ..assembly.assemble import assemble
from ..config import GenEOOptions, KSPOptions
from ..krylov.cg import cg_solve
from ..models import laplacian
from ..ops import local_kernels as lk
from ..partition import native
from ..partition.decompose import partition_and_decompose
from ..solver import solve_assembled
from ..utils.cuda_timing import time_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--nb-part", type=int, default=1024)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--parent", metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("iteration_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    native.build()

    mesh = laplacian.get_input(
        f"--size {args.size} --dim 2 --kappa 10000. minmax")
    geneo = GenEOOptions()
    geneo.lvl1, geneo.lvl2 = "ASM", "E1"
    geneo.dls1.type = "inverse_pallas"
    ksp = KSPOptions(type="cg", rtol=1e-8)
    t0 = time.perf_counter()
    decomp = partition_and_decompose(mesh, args.nb_part, metis_dual=True,
                                     add_overlap=1)
    out = solve_assembled(assemble(mesh, decomp, dev), geneo=geneo, ksp=ksp)
    print(f"[setup] {time.perf_counter() - t0:.1f} s; {out.n_dof} DOF, "
          f"{out.n_dom} domains, n_max {out.assembled.batch.n_max}, "
          f"{out.its} iterations, true residual {out.true_res:.3g}, "
          f"iterations phase {out.timers.get('ksp_iterations'):.5f} s",
          flush=True)
    batch, pc = out.assembled.batch, out.pc
    b = torch.tensor(out.b, dtype=batch.dtype, device=dev)
    kw = dict(rtol=ksp.rtol, atol=ksp.atol, dtol=ksp.dtol, max_it=ksp.max_it,
              norm_type=ksp.norm_type)

    def solve():
        res = cg_solve(batch.matvec, b, pc.apply, x0=pc.x0, **kw)
        torch.cuda.synchronize()
        return res

    def ms_per_iteration():
        out_ms = []
        for _ in range(args.solves):
            t0 = time.perf_counter()
            res = solve()
            out_ms.append((time.perf_counter() - t0) / res.its * 1e3)
        return out_ms, res.its

    def report(label, ms, its):
        print(f"[solve] {label}: {its} iterations; ms per iteration over "
              f"{len(ms)} solves: median {statistics.median(ms):.4f}, "
              f"least {min(ms):.4f}, most {max(ms):.4f}", flush=True)

    solve()
    per_it, its = ms_per_iteration()
    if args.parent:
        from ..assembly import assemble as assemble_mod
        from ..precond import geneo as geneo_mod
        from .parent_kernels import load

        ours = (geneo_mod.fused_local_solve, assemble_mod.block_matvec)
        theirs = load(args.parent)
        old_ms = []
        for _ in range(2):   # with per_it before and after: in turns
            geneo_mod.fused_local_solve, assemble_mod.block_matvec = theirs
            solve()
            ms, old_its = ms_per_iteration()
            old_ms += ms
        geneo_mod.fused_local_solve, assemble_mod.block_matvec = ours
        solve()
        per_it += ms_per_iteration()[0]
        report("parent's K1 and K2", old_ms, old_its)
    report("this tree", per_it, its)

    x = torch.randn(batch.n_dof, dtype=batch.dtype, device=dev)
    xl = batch.gather(x)
    calls = {
        "K1 fused_local_solve": lambda: lk.fused_local_solve(
            pc.l1_factor, pc.pou, batch.mask, xl),
        "K2 block_matvec": lambda: lk.block_matvec(batch.a_neu, xl),
        "gather": lambda: batch.gather(x),
        "scatter_add": lambda: batch.scatter_add(xl),
        "apply_q": lambda: pc.apply_q(x),
        "pc.apply": lambda: pc.apply(x),
        "matvec": lambda: batch.matvec(x),
    }
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        ts = [time_ms(fn, 20) for _ in range(5)]
        print(f"[call] {name}: {statistics.median(ts):.4f} ms "
              f"[{min(ts):.4f}, {max(ts):.4f}]", flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("[trace] the profiler recorded no device time", flush=True)
        return 1
    for key, ms, count in rows[:12]:
        print(f"[trace] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    print(f"[trace] one solve of {res.its} iterations under the profiler: "
          f"wall {wall_ms:.3f} ms, kernel time {busy:.3f} ms, busy share "
          f"{busy / wall_ms:.3f}, idle share {1 - busy / wall_ms:.3f}; "
          f"kernel time over the unprofiled median wall "
          f"{busy / (statistics.median(per_it) * res.its):.3f}", flush=True)
    k12 = sum(r[1] for r in rows if "g4p::" in r[0])
    print(f"[trace] K1 + K2 {k12:.3f} ms, {k12 / busy:.3f} of the kernel "
          f"time", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
