"""The structured 10M case's inner-iteration operators in its three
vector layouts, on one card.

    python -m geneo4petsc_tpu_torch.perf.layout_profile [--size 216]
        [--doms 4] [--overlap 2] [--device cuda]

Sets the repository's structured case up once (laplacian --size 216
--dim 3 --kappa 10000. minmax: 10,077,696 DOF; 4x4x4 boxes, overlap 2;
ASM,E1 with LOBPCG cut 2, 50 iterations; float32), then times with CUDA
events, in turns (a, b, b, a; the median of 10 readings of 20 calls):

1. global layout (StructuredGenEO) against block layout (BlockGenEO,
   structured/blockmode.py): the global matvec, the PC apply, and the
   halo gather / scatter beside the block layout's halo extension / fold;
2. global layout against its one-rank split (ShardedGenEO of
   structured/sharded.py, in a world-size-1 group of this process: NCCL
   on cuda, gloo on cpu): the matvec, the apply, the gather and scatter,
   and one inner product (the all_reduce of one partial);
3. one float32 inner CG solve (rtol 1e-5) per layout: ms per iteration.

Every time is a reading of this run on this card, whose name and power
limit are printed first.  ``--device cpu --size 24 --doms 2`` rehearses
it here (the times then are host times, not the card's).
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import GenEOOptions
from ..krylov import common as cm
from ..parallel import multiproc
from ..structured.blockmode import build_block_mode
from ..structured.decompose import StructuredDecomposition
from ..structured.geneo import setup_structured
from ..structured.grid import laplacian_grid
from ..structured.sharded import shard_structured
from ..structured.solve import make_structured_inner
from ..utils.cuda_timing import time_in_turns


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return "nvidia-smi not available"


def _turns(label, a, b, names):
    if torch.cuda.is_available():
        ta, tb = time_in_turns(a, b)
        print(f"[layout] {label}: {names[0]} {ta['ms']:.4f} ms "
              f"[{ta['min_ms']:.4f}, {ta['max_ms']:.4f}], {names[1]} "
              f"{tb['ms']:.4f} ms [{tb['min_ms']:.4f}, {tb['max_ms']:.4f}]",
              flush=True)
        return
    t0 = time.perf_counter()
    a()
    t1 = time.perf_counter()
    b()
    print(f"[layout] {label}: {names[0]} {1e3 * (t1 - t0):.3f} ms, "
          f"{names[1]} {1e3 * (time.perf_counter() - t1):.3f} ms "
          "(host clock)", flush=True)


def _per_iteration(label, pc, r, ip=cm.LOCAL):
    inner = make_structured_inner(pc, 2000, "cg", ip=ip)
    inner(r, 1e-5)                          # warm
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = inner(r, 1e-5)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"[layout] inner solve, {label}: {res.its} iterations, "
          f"{ms / max(res.its, 1):.4f} ms an iteration", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=216)
    ap.add_argument("--doms", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(_card(), flush=True)
    grid = laplacian_grid(args.size, dim=3, kappa_max=1e4, interp="minmax")
    sd = StructuredDecomposition(grid, (args.doms,) * 3, args.overlap)
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "E1"
    opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 50, 2
    pc, _ = setup_structured(sd, opts, dtype=torch.float32, device=dev)
    blk = build_block_mode(pc, sd, torch.float32, dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        grid.n_nodes)).to(dev, torch.float32)
    xb = blk.to_block(x)
    print(f"[layout] {grid.n_nodes} DOF, {sd.n_dom} domains of "
          f"{pc.local_shape}, dim_e {pc.dim_e}", flush=True)

    _turns("matvec", lambda: pc.matvec(x), lambda: blk.matvec(xb),
           ("global", "block"))
    _turns("PC apply", lambda: pc.apply(x), lambda: blk.apply(xb),
           ("global", "block"))
    xl = pc._gather(x)
    _turns("halo gather / extension", lambda: pc._gather(x),
           lambda: blk._gather(xb), ("global", "block"))
    _turns("halo scatter / fold", lambda: pc._scatter(xl),
           lambda: blk._scatter(xl), ("global", "block"))
    _per_iteration("global", pc, x)
    _per_iteration("block", blk, x)

    store = tempfile.mkdtemp(prefix="layout_profile_")
    multiproc.join_group(f"file://{store}/store", 0, 1, dev)
    try:
        _mv, _ap, sh, shard = shard_structured(pc, multiproc.current(dev))
        xs = shard(x)
        ip = cm.DistInner(sh.ip.group)
        _turns("matvec, rank split", lambda: pc.matvec(x),
               lambda: sh.matvec(xs), ("global", "1 rank"))
        _turns("PC apply, rank split", lambda: pc.apply(x),
               lambda: sh.apply(xs), ("global", "1 rank"))
        _turns("halo gather, rank split", lambda: pc._gather(x),
               lambda: sh._gather(xs), ("global", "1 rank"))
        _turns("halo scatter, rank split", lambda: pc._scatter(xl),
               lambda: sh._scatter(xl), ("global", "1 rank"))
        _turns("inner product", lambda: cm.LOCAL.dot(x, x),
               lambda: ip.dot(xs, xs), ("torch.dot", "all_reduce"))
        _per_iteration("1 rank", sh, xs, ip)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
