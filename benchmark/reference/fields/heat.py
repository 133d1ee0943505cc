"""The heat generator's fields, frozen.

The upstream heat generator (geneo4PETSc tst/heat/heat.cpp) makes one
implicit-Euler step of the heat equation on the laplacian generator's
grid: every edge element is lbd * kappa * [[1 + eps, -1], [-1, 1 + eps]]
+ [[1/3, 1/6], [1/6, 1/3]] / dt, kappa taken at the edge's lower
endpoint, and each node on the lower face of the last active axis
carries the one-node ghost lbd * kappa * (1 + eps) + (1/3) / dt.  The
kappa field is the laplacian generator's (``laplacian.py`` beside this
file, loaded as it is).  The mass term's unit factors break kappa's
separability.

Parameters (a configuration's ``field``): the laplacian generator's
(``size``, ``dim``, ``kappa_max``, ``interp``, ``weak_scaling``) and
``lbd`` and ``dt`` (the generator's defaults 1.0 and 0.1); ``inp_eps``
(default 0.0001, the generator's ``--inpEps``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np


def _laplacian():
    path = Path(__file__).resolve().parent / "laplacian.py"
    spec = importlib.util.spec_from_file_location("_heat_laplacian_field",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _upper_face_zero(shape, axis: int) -> np.ndarray:
    """[nz, ny, nx] ones, zero on the upper face of ``axis`` (0 = x):
    where the edge (v, v + e_axis) exists; all zero on an inactive
    axis."""
    m = np.ones(shape[::-1])
    n = shape[axis]
    ax = 2 - axis
    if n == 1:
        return np.zeros_like(m)
    sl = [slice(None)] * 3
    sl[ax] = slice(n - 1, n)
    m[tuple(sl)] = 0.0
    return m


def make(params: dict) -> dict:
    """The laplacian field's ``shape``, ``kappa``, ``dim`` and ``n_dof``,
    ``separable`` False, ``lbd``, ``dt``, ``inp_eps``, and the explicit
    stencil arrays in float64 ([nz, ny, nx] each): ``edge_off`` (per
    axis, the off-diagonal A[v, v + e] stored at v), ``edge_diag`` (per
    axis, the edge's diagonal added at both endpoints) and ``bc_val``
    (the ghost's diagonal)."""
    lap = _laplacian().make(params)
    lbd = float(params.get("lbd", 1.0))
    dt = float(params.get("dt", 0.1))
    eps = float(params.get("inp_eps", 0.0001))
    kappa, shape, dim = lap["kappa"], tuple(lap["shape"]), lap["dim"]
    edge_off, edge_diag = [], []
    for a in range(3):
        em = _upper_face_zero(shape, a)
        c = kappa * em
        edge_off.append(-lbd * c + em / (6.0 * dt))
        edge_diag.append(lbd * (1.0 + eps) * c + em / (3.0 * dt))
    bc = np.zeros(shape[::-1], dtype=bool)
    bc_sl = [slice(None)] * 3
    bc_sl[2 - (dim - 1)] = slice(0, 1)      # lower face, last active axis
    bc[tuple(bc_sl)] = True
    bc_val = (lbd * (1.0 + eps) * kappa + 1.0 / (3.0 * dt)) * bc
    return {"shape": shape, "kappa": kappa, "dim": dim, "separable": False,
            "n_dof": lap["n_dof"], "lbd": lbd, "dt": dt, "inp_eps": eps,
            "edge_off": tuple(edge_off), "edge_diag": tuple(edge_diag),
            "bc_val": bc_val}
