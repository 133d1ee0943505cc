"""Build and load the CUDA kernels of ``csrc/`` at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds.  The library
lands in ``geneo4petsc_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and the compiler flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing is built at import time.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")
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
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
           "-o", str(tmp), *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with the
    argument types of every entry point declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.g4p_fused_local_solve.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                          c_int, c_int, c_int, vp]
    lib.g4p_fused_local_solve.restype = c_int
    lib.g4p_block_matvec.argtypes = [vp, vp, vp, i64, i64, c_int, vp]
    lib.g4p_block_matvec.restype = c_int
    return lib
