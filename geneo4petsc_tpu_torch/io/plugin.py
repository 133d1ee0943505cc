"""Workload-generator plugin protocol.

The reference loads a user ``.so`` exporting ``getInput`` via dlopen/dlsym
(getLibInput, src/geneo4PETSc.cpp:75-96) with ``#``-separated argument
passing.  This package supports two equivalent plugin kinds:

1. **Python generators** — any callable ``get_input(args: str) -> ElementMesh``
   registered by name (the three reference workloads live in
   ``geneo4petsc_tpu_torch.models``), or addressed as ``module.path:function``.
2. **Native C plugins** — a shared library exporting the flat-C ABI below,
   loaded via ctypes.  (The reference's C++ ABI passes std::vector& and is
   not callable through a C FFI, so the package defines a plain-C
   equivalent; ``native/`` ships the reference workloads compiled against
   it.)

C ABI (two-phase: query sizes, then fill caller-allocated buffers)::

    int getInputSizes(const char* args, unsigned* nbElem, unsigned* nbNode,
                      unsigned* idxLen, unsigned* matLen);
    int getInputFill(const char* args, unsigned* elemPtr, unsigned* elemIdx,
                     double* elemMat);

``elemMat`` holds the per-element dense matrices concatenated row-major in
element order.
"""

from __future__ import annotations

import ctypes
import importlib
from typing import Callable

import numpy as np

from .element_input import ElementMesh, from_lists

_REGISTRY: dict[str, Callable[[str], ElementMesh]] = {}


def register_generator(name: str, fn: Callable[[str], ElementMesh]) -> None:
    _REGISTRY[name] = fn


def expand_args(args: str) -> str:
    """``#``-separated arg passing: tokens joined by ``#`` become spaces."""
    return args.replace("#", " ")


def get_lib_input(lib: str, args: str) -> ElementMesh:
    """Resolve and invoke a generator.

    ``lib`` may be a registered name (``laplacian``), a dotted python path
    (``pkg.mod:fn``), or a path to a ``.so`` implementing the C ABI.
    """
    args = expand_args(args)
    if lib not in _REGISTRY:
        # built-in generators register themselves on import
        from .. import models  # noqa: F401
    if lib in _REGISTRY:
        return _REGISTRY[lib](args)
    if lib.endswith(".so"):
        return _load_c_plugin(lib, args)
    if ":" in lib:
        mod_name, fn_name = lib.split(":", 1)
        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn(args)
    raise ValueError(f"Error: unknown input library {lib}")


def _load_c_plugin(path: str, args: str) -> ElementMesh:
    cdll = ctypes.CDLL(path)
    sizes = cdll.getInputSizes
    sizes.restype = ctypes.c_int
    fill = cdll.getInputFill
    fill.restype = ctypes.c_int

    nb_elem = ctypes.c_uint(0)
    nb_node = ctypes.c_uint(0)
    idx_len = ctypes.c_uint(0)
    mat_len = ctypes.c_uint(0)
    rc = sizes(args.encode(), ctypes.byref(nb_elem), ctypes.byref(nb_node),
               ctypes.byref(idx_len), ctypes.byref(mat_len))
    if rc != 0:
        raise RuntimeError(f"Error: get input sizes from library KO ({path})")

    elem_ptr = np.zeros(nb_elem.value + 1, dtype=np.uint32)
    elem_idx = np.zeros(idx_len.value, dtype=np.uint32)
    elem_mat = np.zeros(mat_len.value, dtype=np.float64)
    rc = fill(args.encode(),
              elem_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
              elem_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
              elem_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"Error: get input data from library KO ({path})")

    dofs = [elem_idx[elem_ptr[e]:elem_ptr[e + 1]].astype(np.int64)
            for e in range(nb_elem.value)]
    mats = []
    off = 0
    for d in dofs:
        k = len(d)
        mats.append(elem_mat[off:off + k * k].reshape(k, k).copy())
        off += k * k
    return from_lists(dofs, mats, n_nodes=int(nb_node.value))
