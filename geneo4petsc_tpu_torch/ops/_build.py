"""Build and load the CUDA kernels of ``csrc/`` at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one
compiler process per ``.cu`` file and all of them at once, and linked
into one shared library with a plain C interface, loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
The library lands in ``geneo4petsc_tpu_torch/_build/<hash>/``, keyed by
a hash of the sources and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libg4p_kernels.so"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build(ptxas_info: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    ``ptxas_info`` forces a rebuild with ``-Xptxas -v`` and returns the
    compiler's report (registers, shared memory, spills per kernel).
    Returns (library path, compiler output)."""
    out = library_path()
    if out.exists() and not ptxas_info:
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    verbose = ("-Xptxas", "-v") if ptxas_info else ()
    objects, procs = [], []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = out.with_name(f"{src.stem}.{os.getpid()}.o")
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = "", False
    for proc in procs:
        report += proc.communicate()[0]
        failed |= proc.returncode != 0
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)],
            capture_output=True, text=True, check=False)
        report += link.stdout + link.stderr
        failed = link.returncode != 0
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{report}")
    os.replace(tmp, out)
    return out, report


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with the
    argument types of every entry point declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # path, rows, stages, grid, threads, smem: the plan of
    # ops/local_kernels.py (_stream_plan), then the stream
    plan = [c_int, c_int, c_int, c_int, c_int, i64, vp]
    lib.g4p_fused_local_solve.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                          c_int, c_int, c_int, *plan]
    lib.g4p_fused_local_solve.restype = c_int
    lib.g4p_block_matvec.argtypes = [vp, vp, vp, i64, i64, c_int, *plan]
    lib.g4p_block_matvec.restype = c_int
    return lib
