"""Shared structured-grid scan for the laplacian/heat workload generators.

Reproduces the element-emission order of the reference generators
(tst/laplacian/laplacian.cpp:118-189, tst/heat/heat.cpp:195-255): raster scan
over (d3, d2, d1); for each central point, neighbors along axes 1..3 with
offsets (-1, +1); a 1-DOF Dirichlet ghost element is emitted when crossing
the lower boundary along the last axis; interior 2-DOF elements are emitted
once (deduplicated as unordered pairs).  Element order matters: the
partitioner consumes it.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def init_kappa(size: int, interp: str, kappa_max: float) -> tuple[float, float]:
    """Kappa profile parameters (initLaplacian, laplacianServices.cpp:7-26)."""
    alpha, beta = 0.0, 1.0
    x_max = float(size - 1)
    if interp == "quad":
        alpha = (kappa_max - beta) / (x_max * x_max)
    elif interp == "lin":
        alpha = (kappa_max - beta) / x_max
    elif interp == "minmax":
        alpha = kappa_max
        beta = x_max / 3.0
    return alpha, beta


def compute_kappa(interp: str, alpha: float, x: float, beta: float) -> float:
    """Per-axis kappa profile (computeKappa, laplacianServices.cpp:28-39)."""
    if interp == "quad":
        return alpha * x * x + beta
    if interp == "lin":
        return alpha * x + beta
    if interp == "minmax":
        if x >= 2.0 * beta:
            return 1.0
        if x >= beta:
            return alpha
        return 1.0
    return 1.0


def grid_size(size: int, weak_scaling: int, dim: int) -> int:
    """Weak-scaling grid sizing (laplacian.cpp:101-104): DOFs scale with the
    weak-scaling factor, so the 1-D extent scales with its dim-th root."""
    if dim == 1:
        return size * weak_scaling
    # epsilon guard: math.sqrt/cbrt of an exact power can land just below
    # the integer (cbrt(108**3) -> 107.999...), and bare int() would then
    # shrink the grid; genuine non-integer roots still truncate
    if dim == 2:
        return int(math.sqrt(size * size * weak_scaling) + 1e-9)
    return int(math.cbrt(size * size * size * weak_scaling) + 1e-9)


def scan_grid(dim: int, n: int,
              emit_interior: Callable[[int, int, float, float, float], None],
              emit_bc: Callable[[int, float, float, float], None]) -> None:
    """Raster-scan the grid, invoking the element emitters in reference order.

    ``emit_interior(id1, id2, x, y, z)`` and ``emit_bc(id1, x, y, z)`` receive
    the central point's grid coordinates (kappa is evaluated there).
    """
    d1n = n
    d2n = n if dim >= 2 else 1
    d3n = n if dim >= 3 else 1
    seen: set[tuple[int, int]] = set()
    for d3 in range(d3n):
        for d2 in range(d2n):
            for d1 in range(d1n):
                central = d1 + d1n * d2 + d1n * d2n * d3
                for nd in (1, 2, 3):
                    for off in (-1, 1):
                        nd1, nd2, nd3 = d1, d2, d3
                        if nd == 1:
                            nd1 += off
                        elif nd == 2:
                            nd2 += off
                        else:
                            nd3 += off
                        if nd1 >= d1n or nd2 >= d2n or nd3 >= d3n:
                            continue
                        if nd1 < 0 or nd2 < 0 or nd3 < 0:
                            # Dirichlet ghost only when crossing the lower
                            # boundary along the grid's last axis.
                            add_bc = ((dim == 1 and nd == 1 and nd1 == -1)
                                      or (dim == 2 and nd == 2 and nd2 == -1)
                                      or (dim == 3 and nd == 3 and nd3 == -1))
                            if add_bc:
                                emit_bc(central, float(d1), float(d2), float(d3))
                            continue
                        neighbor = nd1 + d1n * nd2 + d1n * d2n * nd3
                        key = (min(central, neighbor), max(central, neighbor))
                        if key in seen:
                            continue
                        seen.add(key)
                        emit_interior(central, neighbor,
                                      float(d1), float(d2), float(d3))


def parse_args(args: str, spec: dict[str, type]) -> dict:
    """Tokenized ``--opt value`` parser matching the generators' stringstream
    loops.  ``spec`` maps option name (without ``--``) to int/float/str/bool
    (bool = flag without value)."""
    out: dict = {}
    toks = args.split()
    i = 0
    while i < len(toks):
        name = toks[i].lstrip("-")
        if toks[i].startswith("--") and name in spec:
            ty = spec[name]
            if ty is bool:
                out[name] = True
            elif ty is tuple:  # --kappa MAX INTERP
                out[name] = (float(toks[i + 1]), toks[i + 2])
                i += 2
            else:
                out[name] = ty(toks[i + 1])
                i += 1
        i += 1
    return out


def laplacian_stencil(inp_eps: float, bc: bool, kappa: float) -> np.ndarray:
    """1-D two-node FEM Laplacian stencil (getLaplacian,
    laplacianServices.cpp:41-94): kappa * [[1+eps, -1], [-1, 1+eps]];
    boundary ghost contributes kappa * [[1+eps]]."""
    if bc:
        m = np.array([[1.0 + inp_eps]])
    else:
        m = np.array([[1.0 + inp_eps, -1.0], [-1.0, 1.0 + inp_eps]])
    return kappa * m


def mass_stencil(bc: bool) -> np.ndarray:
    """1-D two-node mass ("inertia") stencil (heat.cpp:24-62)."""
    if bc:
        return np.array([[1.0 / 3.0]])
    return np.array([[1.0 / 3.0, 1.0 / 6.0], [1.0 / 6.0, 1.0 / 3.0]])
