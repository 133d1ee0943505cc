"""Heterogeneous Laplacian workload generator.

Python port of the behavior of tst/laplacian/laplacian.cpp: a 1/2/3-D FEM
Laplacian div(kappa grad u) built from 1-D two-node elements on a structured
grid, with a Dirichlet condition on one face via 1-DOF ghost elements and a
separable heterogeneous coefficient kappa(x, y, z) = kx(x) * ky(y) * kz(z)
with per-axis profiles quad/lin/minmax.

Args string (``#`` already expanded): --size N --weakScaling W --dim D
--inpEps E --kappa MAX INTERP.
"""

from __future__ import annotations

import numpy as np

from ..io.element_input import ElementMesh, from_lists
from . import _grid


def get_input(args: str = "") -> ElementMesh:
    opt = _grid.parse_args(args, {
        "size": int, "weakScaling": int, "dim": int, "inpEps": float,
        "kappa": tuple, "verbose": bool, "debug": bool,
    })
    size = opt.get("size", 4)
    weak = opt.get("weakScaling", 1)
    dim = opt.get("dim", 3)
    inp_eps = opt.get("inpEps", 0.0001)
    kappa_max, interp = opt.get("kappa", (1.0, ""))
    if dim not in (1, 2, 3):
        raise ValueError("Error: invalid command line (--dim)")
    if kappa_max < 1.0:
        raise ValueError("Error: invalid command line (--kappa)")

    n = _grid.grid_size(size, weak, dim)
    alpha, beta = _grid.init_kappa(n, interp, kappa_max)

    elem_dofs: list[np.ndarray] = []
    elem_mats: list[np.ndarray] = []

    def kappa_at(x: float, y: float, z: float) -> float:
        return (_grid.compute_kappa(interp, alpha, x, beta)
                * _grid.compute_kappa(interp, alpha, y, beta)
                * _grid.compute_kappa(interp, alpha, z, beta))

    def emit_interior(i: int, j: int, x: float, y: float, z: float) -> None:
        elem_dofs.append(np.array([i, j], dtype=np.int64))
        elem_mats.append(_grid.laplacian_stencil(inp_eps, False, kappa_at(x, y, z)))

    def emit_bc(i: int, x: float, y: float, z: float) -> None:
        elem_dofs.append(np.array([i], dtype=np.int64))
        elem_mats.append(_grid.laplacian_stencil(inp_eps, True, kappa_at(x, y, z)))

    _grid.scan_grid(dim, n, emit_interior, emit_bc)
    return from_lists(elem_dofs, elem_mats)
