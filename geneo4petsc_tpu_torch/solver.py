"""End-to-end solve orchestration (the reference's solve(),
src/geneo4PETSc.cpp:1283-1394, as a library function).

Pipeline: ElementMesh -> partition/decompose -> assemble (on ``device``)
-> PC setup -> Krylov solve on ``device`` -> results + true-residual
oracle on the host.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from .assembly.assemble import AssembledProblem, assemble
from .config import DriverOptions, GenEOOptions, KSPOptions
from .io import element_input as ei
from .krylov import common as kcm
from .krylov.cg import cg_solve
from .krylov.gmres import gmres_solve
from .parallel import multiproc
from .partition.decompose import partition_and_decompose
from .precond.bjacobi import setup_bjacobi
from .precond.geneo import GenEOStats, setup_geneo
from .precond.mg import setup_mg
from .utils.debug import dump_failure
from .utils.timers import Timers


@dataclass
class SolveOutput:
    result: kcm.SolveResult
    x: np.ndarray
    b: np.ndarray
    pc_name: str
    stats: GenEOStats | None
    timers: Timers
    true_res: float            # || A X - B || / || B ||
    n_dof: int
    n_elems: int
    nnz: int
    n_dom: int
    assembled: AssembledProblem = None
    pc: object = None
    info_l2: str = ""

    @property
    def converged(self) -> bool:
        return self.result.reason >= 0

    @property
    def its(self) -> int:
        return self.result.its


def build_rhs(assembled: AssembledProblem, opt: DriverOptions) -> np.ndarray:
    """Manufactured B = A X with X = (1, 2, ...) unless an RHS file is given
    (createB, src/geneo4PETSc.cpp:807-894)."""
    n = assembled.n_dof
    if opt.inp_file_b:
        return ei.read_rhs_file(opt.inp_file_b, n)
    x = ei.manufactured_solution(n)
    return np.asarray(assembled.a_csr @ x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_assembled(assembled: AssembledProblem,
                    pc_type: str = "geneo",
                    geneo: GenEOOptions | None = None,
                    ksp: KSPOptions | None = None,
                    b: np.ndarray | None = None,
                    driver: DriverOptions | None = None,
                    timers: Timers | None = None,
                    n_devices: int | None = None) -> SolveOutput:
    """Set up the preconditioner and run the Krylov solve on the device
    that holds ``assembled.batch``.  pc_type: "geneo" or "none".

    ``n_devices`` (geneo only): run the Krylov iterations on that many
    ranks with owner-block vectors and a packed halo exchange
    (parallel/dist.py — the reference's ``mpirun -n``,
    src/geneo4PETSc.cpp:1569-1633).  In a torch.distributed group of
    that size this process is one rank (its device holds the rank's
    chunk); with no group, the ranks are launched here, each on a device
    of ``assembled.batch``'s type, and rank 0's result comes back
    (without ``pc`` and ``assembled``)."""
    if n_devices is not None and pc_type == "geneo":
        ranks = multiproc.group_ranks(n_devices, assembled.batch.device)
        if ranks is None:
            return multiproc.run_ranks(
                _rank_solve, n_devices, args=(
                    dataclasses.replace(assembled, batch=_batch_to(
                        assembled.batch, None)),
                    assembled.batch.device.type,
                    dict(pc_type=pc_type, geneo=geneo, ksp=ksp, b=b,
                         driver=driver, timers=timers,
                         n_devices=n_devices)),
                device=assembled.batch.device)
        if assembled.batch.device != ranks.device:
            assembled = dataclasses.replace(
                assembled, batch=_batch_to(assembled.batch, ranks.device))
    else:
        ranks = None
    geneo = geneo or GenEOOptions()
    ksp = ksp or KSPOptions()
    driver = driver or DriverOptions()
    timers = timers or Timers()
    if ksp.type not in ("cg", "gmres"):
        raise ValueError(f"unknown ksp type {ksp.type}")

    batch = assembled.batch
    device, dtype = batch.device, batch.dtype
    n = assembled.n_dof
    if b is None:
        b = build_rhs(assembled, driver)
    b_t = torch.tensor(b, dtype=dtype, device=device)

    # --- PC setup (KSPSetUp equivalent: all the expensive work) ---
    t0 = time.perf_counter()
    stats = None
    info_l2 = ""
    if pc_type == "geneo":
        pc, stats = setup_geneo(batch, geneo, b=b_t,
                                decomp=assembled.decomp, timers=timers,
                                a_csr=assembled.a_csr)
        pc_apply, x0 = pc.apply, pc.x0
        pc_name = geneo.name
        if geneo.lvl2_num:
            info_l2 = f"{geneo.els2.type} cholesky"
    elif pc_type == "bjacobi":
        pc = setup_bjacobi(assembled.a_csr, batch.n_dom, device, dtype)
        pc_apply, x0 = pc.apply, None
        pc_name = "bjacobi"
    elif pc_type == "mg":
        pc = setup_mg(assembled.a_csr, device, dtype,
                      cycle_type=driver.mg_cycle_type,
                      smooth_down=driver.mg_smooth_down,
                      smooth_up=driver.mg_smooth_up)
        pc_apply, x0 = pc.apply, None
        pc_name = "mg"
    elif pc_type == "none":
        pc = pc_apply = None
        x0 = torch.zeros(n, dtype=dtype, device=device)
        pc_name = "none"
    else:
        raise ValueError(f"unknown pc_type {pc_type}")
    _sync(device)
    timers.add("ksp_setup", time.perf_counter() - t0)

    # --- Krylov solve ---
    kw = dict(rtol=ksp.rtol, atol=ksp.atol, dtol=ksp.dtol,
              max_it=ksp.max_it, norm_type=ksp.norm_type)
    if ksp.type == "gmres":
        kw["restart"] = ksp.restart
    solver_fn = cg_solve if ksp.type == "cg" else gmres_solve
    if ranks is not None:
        from .krylov.common import DistInner
        from .parallel.dist import dist_geneo
        node_part = getattr(assembled.decomp, "node_part", None)
        matvec, pc_apply, _pc_d, shard_vec, unshard_vec = dist_geneo(
            pc, ranks, node_part=node_part)
        b_t, x0 = shard_vec(b_t), shard_vec(x0)
        kw["ip"] = DistInner(ranks.group)
    else:
        matvec = batch.matvec
    t0 = time.perf_counter()
    result = solver_fn(matvec, b_t, pc_apply, x0=x0, **kw)
    _sync(device)
    timers.add("ksp_iterations", time.perf_counter() - t0)
    if ranks is not None:
        result = dataclasses.replace(result, x=torch.from_numpy(
            unshard_vec(result.x)))

    x_np = result.x.cpu().numpy().astype(np.float64)
    r = assembled.a_csr @ x_np - b
    bn = np.linalg.norm(b)
    true_res = float(np.linalg.norm(r) / bn) if bn > 0 else float("inf")

    if result.reason < 0 and (ranks is None or ranks.rank == 0):
        # DIVERGED_*: dump Krylov + PC state even with debugging off
        # (checkKSPSolve, src/geneo.cpp:1397-1433)
        dump_failure(result, ksp, pc_name, stats=stats)

    return SolveOutput(result=result, x=x_np, b=np.asarray(b), pc_name=pc_name,
                       stats=stats, timers=timers, true_res=true_res,
                       n_dof=n, n_elems=assembled.mesh.n_elems,
                       nnz=int(np.sum(assembled.nnz_loc)), n_dom=batch.n_dom,
                       assembled=assembled, pc=pc, info_l2=info_l2)


def solve_mesh(mesh: ei.ElementMesh, device, n_dom: int = 2,
               pc_type: str = "geneo",
               geneo: GenEOOptions | None = None,
               ksp: KSPOptions | None = None,
               driver: DriverOptions | None = None,
               timers: Timers | None = None,
               n_devices: int | None = None) -> SolveOutput:
    """partition + decompose + assemble on ``device`` + solve
    (``n_devices``: see solve_assembled)."""
    driver = driver or DriverOptions()
    timers = timers or Timers()
    t0 = time.perf_counter()
    decomp = partition_and_decompose(
        mesh, n_dom, metis_dual=driver.metis_dual,
        add_overlap=driver.add_overlap)
    timers.add("partition", time.perf_counter() - t0)
    t0 = time.perf_counter()
    assembled = assemble(mesh, decomp, device)
    timers.add("create_a", time.perf_counter() - t0)
    return solve_assembled(assembled, pc_type=pc_type, geneo=geneo, ksp=ksp,
                           driver=driver, timers=timers, n_devices=n_devices)


def _batch_to(batch, device):
    """A SubdomainBatch with its arrays on ``device``; ``None``: as NumPy
    arrays (what crosses to a launched rank: plain pickles, no shared
    tensor handles)."""
    def move(v):
        if device is None:
            return v.cpu().numpy()
        return torch.as_tensor(v).to(device)

    return dataclasses.replace(batch, **{
        f.name: move(getattr(batch, f.name))
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), (torch.Tensor, np.ndarray))})


def _rank_solve(assembled, device_type, kw):
    """One launched rank of solve_assembled(n_devices=...)."""
    out = solve_assembled(dataclasses.replace(
        assembled, batch=_batch_to(assembled.batch, multiproc.current(
            device_type).device)), **kw)
    return dataclasses.replace(out, pc=None, assembled=None)
