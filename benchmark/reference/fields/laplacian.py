"""The laplacian generator's coefficient field, frozen.

Copy of the upstream generator's arithmetic (geneo4PETSc
tst/laplacian/laplacianServices.cpp:7-39, initLaplacian and
computeKappa; laplacian.cpp:101-104 for the weak-scaling size): kappa
is the product kz(z) * ky(y) * kx(x) of one per-axis profile (quad,
lin or minmax) evaluated at the node's coordinate, so it is separable.

Parameters (a configuration's ``field``): ``size``, ``dim``,
``kappa_max``, ``interp`` ("quad", "lin", "minmax" or "") and
``weak_scaling`` (default 1).
"""

from __future__ import annotations

import math

import numpy as np


def _init_kappa(size: int, interp: str, kappa_max: float):
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


def _profile(m: int, interp: str, alpha: float, beta: float) -> np.ndarray:
    # an inactive axis has the one coordinate 0
    xs = np.arange(m, dtype=np.float64)
    if interp == "quad":
        return alpha * xs * xs + beta
    if interp == "lin":
        return alpha * xs + beta
    if interp == "minmax":
        return np.where(xs >= 2.0 * beta, 1.0,
                        np.where(xs >= beta, alpha, 1.0))
    return np.ones(m)


def _grid_size(size: int, weak_scaling: int, dim: int) -> int:
    if dim == 1:
        return size * weak_scaling
    root = math.sqrt if dim == 2 else math.cbrt
    return int(root(size ** dim * weak_scaling) + 1e-9)


def make(params: dict) -> dict:
    """{"shape": (nx, ny, nz), "kappa": [nz, ny, nx] float64, "dim",
    "separable": True, "n_dof"}."""
    dim = int(params.get("dim", 3))
    interp = params.get("interp", "")
    n = _grid_size(int(params["size"]), int(params.get("weak_scaling", 1)),
                   dim)
    alpha, beta = _init_kappa(n, interp, float(params["kappa_max"]))
    nx = n
    ny = n if dim >= 2 else 1
    nz = n if dim >= 3 else 1
    kx, ky, kz = (_profile(m, interp, alpha, beta) for m in (nx, ny, nz))
    kappa = kz[:, None, None] * ky[None, :, None] * kx[None, None, :]
    return {"shape": (nx, ny, nz), "kappa": kappa, "dim": dim,
            "separable": True, "n_dof": nx * ny * nz}
