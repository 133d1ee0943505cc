"""The kernels of an earlier commit, for timing beside this tree's.

``load(parent_dir)`` builds the CUDA sources of the checkout at
``parent_dir`` (made with ``git archive``; only its
``geneo4petsc_tpu_torch/`` is needed) with that checkout's own build
script and returns two functions with the signatures of the wrappers of
ops/local_kernels.py.  It knows the entry points as they were before the
kernels took a launch plan:
``g4p_block_matvec(a, x, out, n_dom, n, is_f64, stream)`` and
``g4p_fused_local_solve(inv, d, mask, x, out, n_dom, n, pre, post,
is_f64, stream)``.
"""

from __future__ import annotations

import ctypes
import importlib.util

import torch


def load(parent_dir: str):
    spec = importlib.util.spec_from_file_location(
        "g4p_parent_build",
        f"{parent_dir}/geneo4petsc_tpu_torch/ops/_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = ctypes.CDLL(str(build.build()[0]))
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.g4p_block_matvec.argtypes = [vp, vp, vp, i64, i64, c_int, vp]
    lib.g4p_fused_local_solve.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                          c_int, c_int, c_int, vp]

    def _raise(name, err):
        if err != 0:
            raise RuntimeError(f"parent {name}: CUDA error {err}")

    def block_matvec(a, xl):
        out = torch.empty_like(xl)
        _raise("block_matvec", lib.g4p_block_matvec(
            a.data_ptr(), xl.data_ptr(), out.data_ptr(), a.shape[0],
            a.shape[1], int(a.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream))
        return out

    def fused_local_solve(inv, d, mask, xl, pre=False, post=False):
        out = torch.empty_like(xl)
        _raise("fused_local_solve", lib.g4p_fused_local_solve(
            inv.data_ptr(), d.data_ptr() if d is not None else None,
            mask.data_ptr(), xl.data_ptr(), out.data_ptr(), inv.shape[0],
            inv.shape[1], int(pre), int(post),
            int(inv.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream))
        return out

    return fused_local_solve, block_matvec
