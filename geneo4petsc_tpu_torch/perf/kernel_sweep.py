"""Check and time the batched-GEMV kernels (K1 fused_local_solve, K2
block_matvec) on one CUDA card, under the plan the wrappers choose and
under hand-made plans.

    python -m geneo4petsc_tpu_torch.perf.kernel_sweep [--check-only]
        [--small-only] [--parent DIR]

1. prints the card's name and power limit and builds the kernels with
   the compiler's report (registers, shared memory, spills per kernel);
2. checks both kernels against their plain versions at shapes that reach
   the ring and the direct path;
3. unless ``--check-only``: times K2 at the main shape [1024, 496, 496]
   float64 under a list of plans (ring: rows per stage, stages, consumer
   warps, blocks per SM; direct: rows per block), each in turns with
   ``torch.bmm`` on the same inputs, and K1 under the wrappers' plan;
   then K2 on both paths at shapes with small blocks (``--small-only``
   runs just this part).

4. the host side of one K2 call at the small batches of the generic
   path's main paths ([2, 56, 56], [2, 80, 80], [4, 1080, 1080],
   [64, 448, 448] float64): microseconds of host time a call for the
   wrapper's checks, its plan (cached and not), the current stream (as a
   Stream object and as the raw handle the wrappers take), the device
   guard (taken only off the current card), the launch, the whole
   wrapper, and
   torch.bmm's dispatch, each over many calls without a synchronization.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. made with
``git archive``) it also times that commit's wrappers (its host code
launching its kernels) in turns with this tree's, and beside torch.bmm,
at the main shape and the small batches of step 4.

The list of plans is a measuring tool: the wrappers of
ops/local_kernels.py always take the plan of ``_stream_plan``.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import local_kernels as lk
from ..utils import roofline
from ..utils.cuda_timing import time_in_turns

MAIN = (1024, 496)
# the small batches the generic path's main paths give K2 (golden and
# mg cases of generic-family, its lobpcg cases)
SMALL_SHAPES = [(2, 56), (2, 80), (4, 1080), (64, 448)]
CHECK_SHAPES = [((1024, 496), torch.float64), ((3, 37), torch.float64),
                ((3, 37), torch.float32), ((7, 50), torch.float64),
                ((5, 66), torch.float32), ((5, 64), torch.float32),
                ((133, 496), torch.float64), ((2, 3000), torch.float64),
                ((1, 1), torch.float64), ((300, 16), torch.float64)]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _data(n_dom, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    inv = torch.from_numpy(rng.standard_normal((n_dom, n, n))).to(dev, dtype)
    d = torch.from_numpy(rng.random((n_dom, n)) + 0.5).to(dev, dtype)
    mask = torch.from_numpy(rng.random((n_dom, n)) > 0.2).to(dev)
    x = torch.from_numpy(rng.standard_normal((n_dom, n))).to(dev, dtype)
    return inv, d, mask, x


def _rel(got, want):
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-300))


def report_build() -> None:
    _, report = _build.build(ptxas_info=True)
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"[ptxas] {name}: "
                  f"{line.strip().removeprefix('ptxas info    : ')}")
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", report))
    print(f"[ptxas] spills in all kernels: {spills} bytes", flush=True)
    _build.load()


def check() -> bool:
    ok = True
    for (n_dom, n), dtype in CHECK_SHAPES:
        inv, d, mask, x = _data(n_dom, n, dtype)
        plan = lk.plan_for(inv)
        errs = []
        for pre, post in ((False, False), (True, False), (False, True),
                          (True, True)):
            got = lk.fused_local_solve(inv, d, mask, x, pre, post)
            errs.append(_rel(got, lk.fused_local_solve_plain(
                inv, d, mask, x, pre, post)))
        got = lk.block_matvec(inv, x)
        errs.append(_rel(got, lk.block_matvec_plain(inv, x)))
        same = torch.equal(got, lk.block_matvec(inv, x))
        # the direct path on the same data, forced by a plan of its own
        direct = lk._stream_plan(n_dom, n, inv.element_size(), False, 1, 0)
        errs.append(_rel(lk._block_matvec_cuda(inv, x, direct),
                         lk.block_matvec_plain(inv, x)))
        torch.cuda.synchronize()
        good = max(errs) <= TOL[dtype] and same
        ok &= good
        print(f"[check] [{n_dom},{n},{n}] {str(dtype)[6:]} {plan.path} "
              f"rows {plan.rows} stages {plan.stages} grid {plan.grid}: "
              f"max rel err {max(errs):.3e} same bits {same} "
              f"{'ok' if good else 'FAILED'}", flush=True)
        del inv, d, mask, x
    return ok


def _ring(n_dom, n, itemsize, rows, stages, threads, blocks_per_sm, sms,
          extra=0):
    items = n_dom * -(-n // rows)
    return lk.StreamPlan("ring", rows, stages,
                         min(items, blocks_per_sm * sms), threads,
                         lk._ring_smem(n, itemsize, extra, rows, stages))


def _direct(n_dom, n, itemsize, threads):
    rows = threads // 32 * lk.ROWS_PER_WARP
    return lk.StreamPlan("direct", rows, 0, n_dom * -(-n // rows), threads,
                         n * itemsize)


def sweep() -> None:
    n_dom, n = MAIN
    inv, d, mask, x = _data(n_dom, n, torch.float64)
    sms, _ = lk._device_limits(torch.cuda.current_device())
    moved = (inv.numel() + 2 * x.numel()) * inv.element_size()
    bound_ms, bound_by = roofline.bound_ms(moved, 2 * inv.numel(),
                                           torch.float64,
                                           roofline.device_peaks())
    plans = [lk.plan_for(inv)]
    plans += [_ring(n_dom, n, 8, *v, sms) for v in (
        (8, 7, 96, 1), (8, 2, 96, 1), (4, 8, 64, 1), (16, 3, 160, 1),
        (16, 3, 288, 1), (16, 2, 160, 1), (20, 2, 192, 1), (24, 2, 224, 1),
        (28, 2, 256, 1), (8, 3, 96, 2), (12, 2, 128, 2), (4, 3, 64, 4))]
    plans += [_direct(n_dom, n, 8, t) for t in (256, 128, 64)]

    def lib():
        return torch.bmm(inv, x.unsqueeze(-1))

    print(f"[sweep] K2 [{n_dom},{n},{n}] float64, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({moved} B, {2 * inv.numel()} operations)",
          flush=True)
    for plan in plans:
        want = lk.block_matvec_plain(inv, x)
        err = _rel(lk._block_matvec_cuda(inv, x, plan), want)
        k, b = time_in_turns(lambda: lk._block_matvec_cuda(inv, x, plan), lib)
        print(f"[sweep] {plan.path} rows {plan.rows} stages {plan.stages} "
              f"threads {plan.threads} grid {plan.grid} smem {plan.smem}: "
              f"kernel {k['ms']:.4f} ms [{k['min_ms']:.4f}, "
              f"{k['max_ms']:.4f}], bmm {b['ms']:.4f} ms "
              f"[{b['min_ms']:.4f}, {b['max_ms']:.4f}], share of bound "
              f"{bound_ms / k['ms']:.3f}, err {err:.1e}", flush=True)
    for pre, post in ((False, False), (True, True)):
        extra = lk._local_solve_extra(n, 8, post)
        for plan in (lk.plan_for(inv, extra),
                     _ring(n_dom, n, 8, 8, 6, 96, 1, sms, extra),
                     _ring(n_dom, n, 8, 24, 2, 224, 1, sms, extra),
                     _direct(n_dom, n, 8, 256)):
            k, b = time_in_turns(lambda: lk._fused_local_solve_cuda(
                inv, d, mask, x, pre, post, plan), lib)
            print(f"[sweep] K1 pre={pre} post={post} {plan.path} rows "
                  f"{plan.rows} stages {plan.stages} threads {plan.threads}"
                  f": kernel {k['ms']:.4f} ms [{k['min_ms']:.4f}, "
                  f"{k['max_ms']:.4f}], bmm {b['ms']:.4f} ms", flush=True)


def small_blocks() -> None:
    """Ring against direct where a domain's block is about one stage or
    less, so that a ring block meets a new domain at (almost) every
    tile: the measurement behind the plan's choice between the paths."""
    for n_dom, n in ((8192, 32), (4096, 48), (4096, 64), (2048, 90),
                     (2048, 96), (2048, 128), (1024, 192), (512, 256)):
        inv, _, _, x = _data(n_dom, n, torch.float64)
        ring = lk.plan_for(inv)
        if ring.path != "ring":
            raise RuntimeError(f"[{n_dom},{n},{n}] is not planned as a ring")
        direct = _direct(n_dom, n, 8, lk.DIRECT_THREADS)

        def lib():
            return torch.bmm(inv, x.unsqueeze(-1))

        r, b = time_in_turns(lambda: lk._block_matvec_cuda(inv, x, ring), lib)
        d, _ = time_in_turns(
            lambda: lk._block_matvec_cuda(inv, x, direct), lib)
        print(f"[small] K2 [{n_dom},{n},{n}] float64 ({n * n * 8} B a "
              f"domain): ring rows {ring.rows} stages {ring.stages} "
              f"{r['ms']:.4f} ms, direct {d['ms']:.4f} ms, bmm "
              f"{b['ms']:.4f} ms", flush=True)
        del inv, x


def _host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls, with no
    synchronization between them (the card runs behind)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def host_cost() -> None:
    """The host side of one K2 call, piece by piece (see the docstring)."""
    for n_dom, n in SMALL_SHAPES:
        inv, _, _, x = _data(n_dom, n, torch.float64)
        plan = lk.plan_for(inv)

        def guard():
            with torch.cuda.device(inv.device):
                pass

        pieces = {
            "checks": lambda: lk._check("block_matvec", inv, {"x": x}),
            "plan": lambda: lk.plan_for(inv),
            "plan uncached": lambda: lk._stream_plan(
                n_dom, n, 8, True,
                *lk._device_limits(torch.cuda.current_device())),
            "stream object": lambda: torch.cuda.current_stream().cuda_stream,
            "raw stream": lambda: torch._C._cuda_getCurrentRawStream(
                inv.device.index),
            "device guard": guard,
            "launch": lambda: lk._block_matvec_cuda(inv, x, plan),
            "wrapper": lambda: lk.block_matvec(inv, x),
            "torch.bmm": lambda: torch.bmm(inv, x.unsqueeze(-1)),
        }
        line = ", ".join(f"{k} {_host_us(f):.2f}" for k, f in pieces.items())
        print(f"[host] K2 [{n_dom},{n},{n}] float64, host us a call: {line}",
              flush=True)
        del inv, x


def compare_with_parent(parent_dir: str) -> None:
    """This tree's K1/K2 wrappers in turns with the wrappers (host code
    and kernels) of the checkout at ``parent_dir``, and K2 beside
    torch.bmm, at the main shape and the small batches."""
    from .parent_kernels import load

    old = load(parent_dir)
    for n_dom, n in [MAIN] + SMALL_SHAPES:
        inv, d, mask, x = _data(n_dom, n, torch.float64)
        if _rel(old.block_matvec(inv, x),
                lk.block_matvec_plain(inv, x)) > 1e-12:
            raise RuntimeError("the parent's K2 disagrees with the plain "
                               "version")

        def lib():
            return torch.bmm(inv, x.unsqueeze(-1))

        for name, new_fn, old_fn in (
                ("K2", lambda: lk.block_matvec(inv, x),
                 lambda: old.block_matvec(inv, x)),
                ("K1", lambda: lk.fused_local_solve(inv, None, mask, x),
                 lambda: old.fused_local_solve(inv, None, mask, x))):
            new_t, old_t = time_in_turns(new_fn, old_fn)
            line = (f"[parent] {name} [{n_dom},{n},{n}] float64: this tree "
                    f"{new_t['ms']:.4f} ms [{new_t['min_ms']:.4f}, "
                    f"{new_t['max_ms']:.4f}], parent {old_t['ms']:.4f} ms "
                    f"[{old_t['min_ms']:.4f}, {old_t['max_ms']:.4f}]")
            if name == "K2":
                _, b = time_in_turns(new_fn, lib)
                line += (f", torch.bmm {b['ms']:.4f} ms [{b['min_ms']:.4f},"
                         f" {b['max_ms']:.4f}]")
            print(line, flush=True)
        del inv, d, mask, x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--small-only", action="store_true")
    ap.add_argument("--parent", metavar="DIR")
    args = ap.parse_args(argv)
    if roofline.device_peaks() is None:
        print("kernel_sweep: no CUDA card the peaks table knows",
              file=sys.stderr)
        return 1
    print(roofline.smi_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    report_build()
    if not check():
        return 1
    if args.small_only:
        small_blocks()
        return 0
    if not args.check_only:
        sweep()
        small_blocks()
    host_cost()
    if args.parent:
        compare_with_parent(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
