"""Multi-process runs: one process per device, on ``torch.distributed``.

The reference's primary interface is ``mpirun -n N geneo4PETSc ...``:
ranks are processes, and distribution is tested with local ranks
(src/geneo4PETSc.cpp:1569-1633; tst/dummy/dummy.sh pins 2).  Here a rank
is a process that owns one device: ``cuda:r`` under NCCL, or the host
under gloo.  Two ways to start ranks:

* **mpirun style**: the user starts every process with

      GENEO_COORDINATOR=host:port GENEO_NUM_PROCS=N GENEO_PROC_ID=i \\
          python -m geneo4petsc_tpu_torch ... --nbDevices auto

  (``GENEO_COORDINATOR`` may also be a ``tcp://`` or ``file://`` URL);
  ``init_from_env`` joins the group.
* **one command**: ``--nbDevices D`` (or ``n_devices=D`` in the library)
  with no group yet launches D local ranks itself (``run_ranks``, spawn
  start method); rank 0's result comes back to the caller.

Every rank runs the same program.  Host work (grids, partitioning, the
preconditioner setup) is replicated deterministically on each rank; the
iteration-phase data is then cut to each rank's chunk (parallel/dist.py,
parallel/sharded.py, structured/sharded.py).  NCCL needs one card a rank:
D ranks on ``cuda`` ask for D cards.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

# a rank that waits this long on a collective has lost its peers
TIMEOUT_S = 600
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@dataclass(frozen=True)
class Ranks:
    """This process's place in the group: rank, size, the group, its
    device."""

    rank: int
    size: int
    group: object
    device: torch.device


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def join_group(init_method: str, rank: int, size: int, device) -> None:
    """Join (or, as rank 0, open) a group of ``size`` ranks: NCCL with
    card ``rank`` for cuda, gloo for cpu."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(device), init_method=init_method,
                            rank=rank, world_size=size,
                            timeout=timedelta(seconds=TIMEOUT_S))


def init_from_env(device="cuda") -> bool:
    """Join the group described by GENEO_COORDINATOR / GENEO_NUM_PROCS /
    GENEO_PROC_ID (the mpirun -n analogue).  Returns True when a
    multi-process run was configured (or a group already exists), False
    for the single-process default."""
    coord = os.environ.get("GENEO_COORDINATOR", "")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    init = coord if "://" in coord else f"tcp://{coord}"
    join_group(init, int(os.environ.get("GENEO_PROC_ID", "0")),
               int(os.environ.get("GENEO_NUM_PROCS", "1")), device)
    return True


def current(device) -> Ranks:
    """This process's Ranks (the group must exist); ``device`` is the
    device type the caller asked for: a CUDA rank takes its current
    card."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return Ranks(rank=dist.get_rank(), size=dist.get_world_size(),
                 group=dist.group.WORLD, device=device)


def group_ranks(n_devices: int, device) -> Ranks | None:
    """The Ranks of a run on ``n_devices`` ranks when this process is in
    such a group; None when no group exists (the caller then launches
    the ranks).  A group of another size is an error."""
    if not dist.is_initialized():
        return None
    if dist.get_world_size() != n_devices:
        raise ValueError(f"n_devices={n_devices}, but this process is in a "
                         f"group of {dist.get_world_size()} ranks")
    return current(device)


def check_cards(n_devices: int, device) -> None:
    """NCCL needs one card a rank: refuse a request the machine cannot
    hold (never fall back to the CPU)."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise ValueError(f"--nbDevices {n_devices} on cuda needs "
                             f"{n_devices} cards (one a rank); this machine "
                             f"has {have}")


def process_summary() -> str:
    size = dist.get_world_size()
    return (f"process {dist.get_rank()}/{size}, 1 local / {size} global "
            "devices")


def _worker(rank, size, init_method, device, fn, args, queue):
    torch.set_num_threads(1)
    try:
        join_group(init_method, rank, size, device)
        out = fn(*args)
        if rank == 0:
            # by value: a shared-memory tensor handle would not outlive
            # this process
            queue.put(("ok", pickle.dumps(out)))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args=(), device="cpu", init_method=None,
              timeout: float = 3 * TIMEOUT_S):
    """Run ``fn(*args)`` on ``n`` local ranks (spawned processes, one
    thread each) and return rank 0's result.  ``init_method``: the
    rendezvous URL (default: a ``file://`` store in a fresh temporary
    directory).  A rank that fails or outlives ``timeout`` seconds fails
    the call; every rank is stopped before it returns."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp

    check_cards(n, device)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="geneo_ranks_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, n, init_method, str(device), fn, args,
                               queue)) for r in range(n)]
    # one host thread a rank: ranks that each start a full OpenMP /
    # BLAS pool on a shared host slow each other by orders of magnitude
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    try:
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        while True:
            try:
                msg = queue.get(timeout=0.5)
                break
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited with codes {dead}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{n} ranks gave no result in "
                                       f"{timeout} s")
        if msg[0] != "ok":
            raise RuntimeError(f"rank {msg[1]} failed:\n{msg[2]}")
        for p in procs:
            p.join(timeout=TIMEOUT_S)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return pickle.loads(msg[1])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
