"""Implicit-Euler heat-step workload generator.

Python port of the behavior of tst/heat/heat.cpp: element matrix =
lbd * Laplacian + Mass / dt on the same structured grid scan as the
laplacian generator, with extra args --lbd (default 1.0) and --dt
(default 0.1).
"""

from __future__ import annotations

import numpy as np

from ..io.element_input import ElementMesh, from_lists
from . import _grid


def get_input(args: str = "") -> ElementMesh:
    opt = _grid.parse_args(args, {
        "size": int, "weakScaling": int, "dim": int, "inpEps": float,
        "kappa": tuple, "lbd": float, "dt": float,
        "verbose": bool, "debug": bool,
    })
    size = opt.get("size", 4)
    weak = opt.get("weakScaling", 1)
    dim = opt.get("dim", 3)
    inp_eps = opt.get("inpEps", 0.0001)
    kappa_max, interp = opt.get("kappa", (1.0, ""))
    lbd = opt.get("lbd", 1.0)
    dt = opt.get("dt", 0.1)
    if dim not in (1, 2, 3):
        raise ValueError("Error: invalid command line (--dim)")

    n = _grid.grid_size(size, weak, dim)
    alpha, beta = _grid.init_kappa(n, interp, kappa_max)

    elem_dofs: list[np.ndarray] = []
    elem_mats: list[np.ndarray] = []

    def kappa_at(x: float, y: float, z: float) -> float:
        return (_grid.compute_kappa(interp, alpha, x, beta)
                * _grid.compute_kappa(interp, alpha, y, beta)
                * _grid.compute_kappa(interp, alpha, z, beta))

    def heat_mat(bc: bool, x: float, y: float, z: float) -> np.ndarray:
        lap = _grid.laplacian_stencil(inp_eps, bc, kappa_at(x, y, z))
        return lbd * lap + _grid.mass_stencil(bc) / dt

    def emit_interior(i: int, j: int, x: float, y: float, z: float) -> None:
        elem_dofs.append(np.array([i, j], dtype=np.int64))
        elem_mats.append(heat_mat(False, x, y, z))

    def emit_bc(i: int, x: float, y: float, z: float) -> None:
        elem_dofs.append(np.array([i], dtype=np.int64))
        elem_mats.append(heat_mat(True, x, y, z))

    _grid.scan_grid(dim, n, emit_interior, emit_bc)
    return from_lists(elem_dofs, elem_mats)
