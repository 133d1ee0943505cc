"""Rank-side probes of the multi-rank layouts, for the parity tests and
``chip_smoke.py``.

Each probe runs on every rank of a group (``multiproc.run_ranks`` passes
it to the ranks): it builds the same problem on every rank, sets the
preconditioner up there, cuts it to the rank's chunk, applies the
rank-split operators to a seeded vector and runs a Krylov solve, and
returns the gathered global results (rank 0's copy reaches the caller)
beside the single-process ones, which rank 0 alone computes (the other
ranks return None for them).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import GenEOOptions
from ..krylov.cg import cg_solve
from ..krylov.common import DistInner
from ..krylov.gmres import gmres_solve
from . import multiproc


def _opts(lvl: str, cut: int = 0) -> GenEOOptions:
    g = GenEOOptions()
    g.lvl1, g.lvl2 = lvl.split(",")
    g.cut = cut
    return g


def generic(gen_args: str, n_dom: int, overlap: int, lvls, layout="dist",
            node_part=True, rtol=1e-8, seed=0, device="cpu",
            ksp="cg", model="laplacian", max_it=300) -> dict:
    """The generic path (the ``model`` generator), float64: for each
    ``lvls`` entry "L1,L2", the rank-split matvec and PC apply of a
    seeded vector, the Krylov iterations on b = A (1..n), and those of
    the single-process layout.  ``layout``: "dist" (owner blocks,
    parallel/dist.py) or "replicated" (parallel/sharded.py)."""
    from .. import models
    from ..assembly.assemble import assemble
    from ..partition.decompose import partition_and_decompose
    from ..precond.geneo import setup_geneo
    from .dist import dist_geneo
    from .sharded import shard_geneo

    ranks = multiproc.current(device)
    mesh = getattr(models, model).get_input(gen_args)
    decomp = partition_and_decompose(mesh, n_dom, add_overlap=overlap)
    ap = assemble(mesh, decomp, ranks.device)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        mesh.n_nodes)).to(ranks.device)
    b = torch.from_numpy(ap.a_csr @ np.arange(1.0, mesh.n_nodes + 1)).to(
        ranks.device)
    solver = cg_solve if ksp == "cg" else gmres_solve
    out = {"n_dof": mesh.n_nodes}
    for lvl in lvls:
        pc, _ = setup_geneo(ap.batch, _opts(lvl), decomp=decomp,
                            a_csr=ap.a_csr)
        lead = ranks.rank == 0
        ref = solver(ap.batch.matvec, b, pc.apply, rtol=rtol,
                     max_it=max_it) if lead else None
        if layout == "dist":
            mv, pa, _pcd, shard, unshard = dist_geneo(
                pc, ranks, node_part=decomp.node_part if node_part else None)
            ip = DistInner(ranks.group)
        else:
            mv, pa, _pcs = shard_geneo(pc, ranks)
            shard = unshard = None
            ip = None

        def run(f, v):
            if shard is None:
                return f(v).cpu().numpy()
            return unshard(f(shard(v)))

        res = solver(mv, b if shard is None else shard(b), pa, rtol=rtol,
                     max_it=max_it, **({} if ip is None else {"ip": ip}))
        xs = res.x.cpu().numpy() if shard is None else unshard(res.x)
        out[lvl] = {
            "matvec": run(mv, x), "apply": run(pa, x),
            "matvec_1": ap.batch.matvec(x).cpu().numpy() if lead else None,
            "apply_1": pc.apply(x).cpu().numpy() if lead else None,
            "its": res.its, "reason": res.reason,
            "its_1": ref.its if lead else None,
            "true_res": float(np.linalg.norm(ap.a_csr @ xs - b.cpu().numpy())
                              / np.linalg.norm(b.cpu().numpy()))}
        if layout == "dist":
            from .dist import plan_for
            plan = plan_for(ap.batch, ranks.size,
                            decomp.node_part if node_part else None)
            out[lvl]["wire"] = plan.wire_floats_per_exchange
            out[lvl]["n_tot"] = plan.n_tot
    return out


def structured(kind: str, size: int, dom_grid, overlap: int, lvls,
               rtol=1e-10, seed=0, device="cpu", dtype=torch.float64,
               cut=0, flexible=False, max_it=300) -> dict:
    """The structured (kind "laplacian") or elastic (kind "elastic")
    backend on z-slab ranks: for each "L1,L2" the rank-split matvec and
    apply of a seeded vector beside the single-process ones, and the CG
    iterations of both on the manufactured right-hand side."""
    from ..structured.decompose import StructuredDecomposition
    from ..structured.sharded import shard_elastic, shard_structured

    ranks = multiproc.current(device)
    dev = ranks.device
    if kind == "elastic":
        from ..structured.elastic import elastic_grid, setup_elastic
        grid = elastic_grid(size, kappa_max=100.0, interp="minmax",
                            spring=100.0)
    else:
        from ..structured.geneo import setup_structured
        from ..structured.grid import laplacian_grid
        grid = laplacian_grid(size, dim=3, kappa_max=1000.0, interp="minmax")
    _xt, b_np = grid.manufactured_rhs()
    b = torch.from_numpy(b_np).to(dev, dtype)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        b_np.shape[0])).to(dev, dtype)
    out = {}
    for lvl in lvls:
        if kind == "elastic":
            pc, _ = setup_elastic(grid, tuple(dom_grid), overlap,
                                  _opts(lvl, cut), dtype=dtype, device=dev)
            mv, pa, sh, shard = shard_elastic(pc, ranks)
        else:
            sd = StructuredDecomposition(grid, tuple(dom_grid), overlap)
            pc, _ = setup_structured(sd, _opts(lvl, cut), dtype=dtype,
                                     device=dev)
            mv, pa, sh, shard = shard_structured(pc, ranks)
        lead = ranks.rank == 0
        ref = cg_solve(pc.matvec, b, pc.apply, rtol=rtol, flexible=flexible,
                       max_it=max_it) if lead else None
        res = cg_solve(mv, shard(b), pa, rtol=rtol, flexible=flexible,
                       max_it=max_it, ip=DistInner(ranks.group))
        xs = sh.unshard(res.x)
        out[lvl] = {
            "matvec": sh.unshard(mv(shard(x))),
            "apply": sh.unshard(pa(shard(x))),
            "matvec_1": pc.matvec(x).cpu().numpy() if lead else None,
            "apply_1": pc.apply(x).cpu().numpy() if lead else None,
            "its": res.its, "its_1": ref.its if lead else None,
            "true_res": float(np.linalg.norm(grid.matvec(xs) - b_np)
                              / np.linalg.norm(b_np))}
    return out


def solutions(kind: str, args: tuple, kw: dict, device="cpu") -> list:
    """Run one multi-rank solve (kind "structured", "elastic" or
    "generic") on every rank and return each rank's (inner iterations,
    solution) — every rank must hold the same result."""
    import torch.distributed as dist

    if kind == "structured":
        from ..structured.solve import solve_structured as solve
    elif kind == "elastic":
        from ..structured.elastic import solve_elastic as solve
    else:
        from ..solver import solve_mesh as solve
    out = solve(*args, **kw)
    its = out.refined.inner_its if kind != "generic" else out.its
    mine = (int(its), np.asarray(out.x))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def solve(kind: str, args: tuple, kw: dict) -> dict:
    """One multi-rank solve (kind "structured" or "elastic") through the
    library entry point in this group: its counts, coarse dimension, true
    residual and whether the setup came from a checkpoint."""
    if kind == "structured":
        from ..structured.solve import solve_structured as fn
    else:
        from ..structured.elastic import solve_elastic as fn
    out = fn(*args, **kw)
    return {"inner": out.refined.inner_its, "outer": out.refined.outer_its,
            "dim_e": int(out.stats.real_dim_e.sum()),
            "true_res": float(out.true_res),
            "checkpoint_hit": "checkpoint_hit" in out.timers.phases}


def cli(argv: list) -> tuple:
    """The port's CLI run as this rank of the group: (return code, what
    rank 0 printed)."""
    from ..cli import _rank_run
    return _rank_run(argv)


def batch(calls: list) -> list:
    """Several probes in one launch: ``calls`` is [(name, args, kwargs)]
    of this module's functions; returns their results in order."""
    return [globals()[name](*args, **kw) for name, args, kw in calls]


def timed_structured(grid_kw: dict, dom_grid, overlap: int, lvl: str,
                     eig_max_it: int, cut: int, block_layout=False,
                     n_devices=None, device="cuda", keep=False) -> dict:
    """One structured solve (float32 inner CG in float64 refinement to
    1e-8) with each inner solve timed by CUDA events: its counts, coarse
    dimension, true residual, wall seconds, phase seconds and the mean
    time of an inner iteration; with ``keep`` also the solve's output
    (``out``, its preconditioner on the card) and the grid (``grid``)."""
    from ..config import KSPOptions
    from ..structured import solve as ssolve
    from ..structured.grid import laplacian_grid

    spans = []
    make = ssolve.make_structured_inner

    def timed(*a, **kw):
        inner = make(*a, **kw)

        def run(r32, rtol):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = inner(r32, rtol)
            end.record()
            spans.append((start, end))
            return res

        return run

    opts = _opts(lvl, cut)
    opts.els2.type, opts.els2.max_it = "lobpcg", eig_max_it
    grid = laplacian_grid(**grid_kw)
    torch.cuda.synchronize()
    ssolve.make_structured_inner = timed
    t0 = time.perf_counter()
    try:
        out = ssolve.solve_structured(
            grid, dom_grid, overlap, geneo=opts, ksp=KSPOptions(type="cg"),
            tol=1e-8, device=device, block_layout=block_layout,
            n_devices=n_devices)
    finally:
        ssolve.make_structured_inner = make
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inner_ms = sum(s.elapsed_time(e) for s, e in spans)
    x = np.asarray(out.x, np.float64)
    kept = {"out": out, "grid": grid} if keep else {}
    return {**kept,
            "inner": out.refined.inner_its, "outer": out.refined.outer_its,
            "dim_e": int(out.stats.real_dim_e.sum()),
            "true_res": float(out.true_res), "wall_s": wall,
            "phases": dict(out.timers.phases), "inner_ms": inner_ms,
            "ms_per_inner_it": inner_ms / max(out.refined.inner_its, 1),
            "err_max_over_n": float(np.max(np.abs(
                x - np.arange(1.0, x.size + 1)))) / x.size,
            "finite": bool(np.isfinite(x).all())}
