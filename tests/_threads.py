"""The thread budget of a test process, and the one way tests pin torch's
intra-op thread count.

``apply_budget()`` (this module's ``pytest_configure``; tests/test_threads.py
loads it as a plugin for the whole session): under ``pytest -n W`` each
worker gets ``budget() = max(2, cores // W)`` threads for torch, OpenMP and
BLAS (all cores without xdist); W workers whose pools each take every core
slow each other several times over.  The floor is 2: the float32
refinement of tests/test_torch_lobpcg_generic.py takes another inner count
on one thread (it pins its own count all the same).

``torch_threads(n)``: ``torch.set_num_threads(n)`` for a block.  Setting a
count with torch also sets MKL's count for this thread and turns MKL's
dynamic adjustment off; once that count is above one, MKL's batched LU
inside torch's parallel loops fails ("Parameter 6 was incorrect on entry
to DLASWP") and never returns (``torch.linalg.solve`` on an [8, 216, 216]
batch, torch 2.13 CPU), whatever test runs next in the process; torch
sets them again in a thread whose first parallel call comes after the
count was set.  So the budget is set through the environment and
threadpoolctl, never with ``torch.set_num_threads``, and a pin asks
torch for its count first (which starts the calling thread's pool), then
sets it, and at the block's end gives MKL back its own settings and sets
only OpenMP's count back (tests/test_threads.py holds this).
"""

import contextlib
import ctypes
import os

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def budget() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(2, (os.cpu_count() or 1) // workers)


def apply_budget() -> None:
    """``budget()`` threads for the pools of this process: through the
    environment for those not started yet and for subprocesses, and with
    threadpoolctl for those started (numpy's BLAS, which jax loads in
    tests/conftest.py, and torch's OpenMP where torch is loaded)."""
    n = budget()
    os.environ.update({var: str(n) for var in THREAD_VARS})
    from threadpoolctl import threadpool_limits

    threadpool_limits(n)


def pytest_configure(config):
    apply_budget()


def _reset_mkl(torch) -> None:
    """MKL's per-thread count back to its global one, and its dynamic
    adjustment back on.  A torch built with MKL that does not export
    these two calls is an error: the hang above would come back."""
    if not torch.backends.mkl.is_available():
        return
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    try:
        local, dynamic = lib.MKL_Set_Num_Threads_Local, lib.MKL_Set_Dynamic
    except AttributeError as e:
        raise RuntimeError(
            "torch's MKL cannot be given back its thread settings: a "
            "batched solve after torch.set_num_threads(n > 1) may hang") \
            from e
    local.argtypes, local.restype = [ctypes.c_int], ctypes.c_int
    dynamic.argtypes, dynamic.restype = [ctypes.c_int], None
    local(0)
    dynamic(1)


@contextlib.contextmanager
def torch_threads(n: int):
    import torch
    from threadpoolctl import threadpool_limits

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        _reset_mkl(torch)
        threadpool_limits(before, user_api="openmp")
