"""ctypes loader for the native C++ partitioner (native/kway.cpp).

Same deterministic algorithm as kway.py; used automatically when the
shared library has been built (`make -C native`, or ``build()`` below).
partition_mesh() falls back to the NumPy implementation when the library
is absent — both produce identical partitions.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np

from ..io.element_input import ElementMesh

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE, "libg4pkway.so")


def build() -> str:
    """Compile native/kway.cpp into native/libg4pkway.so with the host C++
    compiler (the flags of native/Makefile) unless it exists; returns
    the library path."""
    if not os.path.exists(LIB_PATH):
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler found to build "
                               "native/libg4pkway.so")
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o",
                        tmp, os.path.join(_NATIVE, "kway.cpp")], check=True)
        os.replace(tmp, LIB_PATH)
    _lib.cache_clear()
    return LIB_PATH


@functools.cache
def _lib():
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        # incompatible platform or corrupt binary: fall back to NumPy
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.g4p_kway_partition.restype = ctypes.c_int
    lib.g4p_kway_partition.argtypes = [ctypes.c_int64, i64p, i64p,
                                       ctypes.c_int64, i64p, ctypes.c_int]
    lib.g4p_mesh_graph_size.restype = ctypes.c_int
    lib.g4p_mesh_graph_size.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                        i64p, i64p, ctypes.c_int, i64p]
    lib.g4p_mesh_graph.restype = ctypes.c_int
    lib.g4p_mesh_graph.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                   i64p, i64p, ctypes.c_int, i64p, i64p]
    return lib


def available() -> bool:
    return _lib() is not None


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def mesh_graph(mesh: ElementMesh, dual: bool):
    lib = _lib()
    eptr = np.ascontiguousarray(mesh.elem_ptr, np.int64)
    eidx = np.ascontiguousarray(mesh.elem_idx, np.int64)
    n_edges = ctypes.c_int64(0)
    rc = lib.g4p_mesh_graph_size(mesh.n_elems, mesh.n_nodes, _p(eptr),
                                 _p(eidx), int(dual),
                                 ctypes.byref(n_edges))
    if rc != 0:
        raise RuntimeError("g4p_mesh_graph_size failed")
    n_vert = mesh.n_elems if dual else mesh.n_nodes
    ptr = np.zeros(n_vert + 1, np.int64)
    idx = np.zeros(n_edges.value, np.int64)
    rc = lib.g4p_mesh_graph(mesh.n_elems, mesh.n_nodes, _p(eptr), _p(eidx),
                            int(dual), _p(ptr), _p(idx))
    if rc != 0:
        raise RuntimeError("g4p_mesh_graph failed")
    return ptr, idx


def kway(ptr: np.ndarray, idx: np.ndarray, n: int, k: int,
         refine_passes: int = 8) -> np.ndarray:
    lib = _lib()
    ptr = np.ascontiguousarray(ptr, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    part = np.zeros(n, np.int64)
    rc = lib.g4p_kway_partition(n, _p(ptr), _p(idx), k, _p(part),
                                refine_passes)
    if rc != 0:
        raise RuntimeError("g4p_kway_partition failed")
    return part


def partition_mesh(mesh: ElementMesh, n_parts: int, dual: bool = True):
    """Native analogue of kway.partition_mesh_py."""
    ptr, idx = mesh_graph(mesh, dual)
    if dual:
        elem_part = kway(ptr, idx, mesh.n_elems, n_parts)
        node_part = np.full(mesh.n_nodes, -1, dtype=np.int64)
        for e in range(mesh.n_elems):
            for nd in mesh.elem_nodes(e):
                if node_part[nd] == -1:
                    node_part[nd] = elem_part[e]
        node_part[node_part == -1] = 0
        return elem_part, node_part
    node_part = kway(ptr, idx, mesh.n_nodes, n_parts)
    elem_part = np.zeros(mesh.n_elems, dtype=np.int64)
    for e in range(mesh.n_elems):
        nodes = mesh.elem_nodes(e)
        labels, counts = np.unique(node_part[nodes], return_counts=True)
        elem_part[e] = labels[np.argmax(counts)]
    return elem_part, node_part
