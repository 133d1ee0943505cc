"""2-D plane-strain linear elasticity workload generator.

Extends the reference's workload set (laplacian/heat/graph) with the
elasticity-style SPD system named by BASELINE.md config #5: bilinear (Q1)
quadrilateral elements on a structured grid, two DOFs per grid node,
heterogeneous Young's modulus E(x, y) via the same kappa profiles as the
laplacian generator, and the bottom face clamped through per-DOF ghost
springs (the reference's ghost-element Dirichlet idiom,
tst/laplacian/laplacian.cpp:35-45).

Vector problems exercise GenEO where it matters most: each floating
subdomain carries three rigid-body modes, so one-level Schwarz degrades
fast and the coarse space must pick the modes up (Nicolaides alone is not
enough — the rotations need the eigensolve).

Args: --size N (grid nodes per side) --nu P --E Y --kappa MAX INTERP
      --weakScaling W --spring S
"""

from __future__ import annotations

import numpy as np

from ..io.element_input import ElementMesh, from_lists
from . import _grid


def q1_plane_strain_stiffness(e_mod: float, nu: float) -> np.ndarray:
    """8x8 element stiffness of a unit Q1 quad (2x2 Gauss), plane strain.

    DOF order: (ux0, uy0, ux1, uy1, ux2, uy2, ux3, uy3) with nodes numbered
    (0,0), (1,0), (0,1), (1,1) in grid order.
    """
    lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e_mod / (2 * (1 + nu))
    d = np.array([[lam + 2 * mu, lam, 0],
                  [lam, lam + 2 * mu, 0],
                  [0, 0, mu]])
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    k = np.zeros((8, 8))
    # shape functions on [-1,1]^2 for nodes (-1,-1), (1,-1), (-1,1), (1,1)
    xs = np.array([-1.0, 1.0, -1.0, 1.0])
    ys = np.array([-1.0, -1.0, 1.0, 1.0])
    for xi in gp:
        for eta in gp:
            dn_dxi = 0.25 * xs * (1 + ys * eta)
            dn_deta = 0.25 * ys * (1 + xs * xi)
            # unit square element: jacobian = diag(1/2, 1/2)
            dn_dx = dn_dxi * 2.0
            dn_dy = dn_deta * 2.0
            b = np.zeros((3, 8))
            b[0, 0::2] = dn_dx
            b[1, 1::2] = dn_dy
            b[2, 0::2] = dn_dy
            b[2, 1::2] = dn_dx
            k += 0.25 * b.T @ d @ b  # det(J) * weight = 1/4
    return k


def _get_input_3d(n: int, nu: float, e_mod: float, kappa_max: float,
                  interp: str, spring: float) -> ElementMesh:
    """3-D Q1 hexahedral elasticity (3 DOF/node, z = 0 face clamped) —
    the element-list twin of the structured elastic backend's grid, so
    the generic dense path can cross-validate the vector scale backend."""
    from ..structured.elastic import _CORNERS, q1_hex_stiffness

    alpha, beta = _grid.init_kappa(n, interp, kappa_max)
    k_ref = q1_hex_stiffness(e_mod, nu)
    pr = np.array([_grid.compute_kappa(interp, alpha, i + 0.5, beta)
                   for i in range(n - 1)])

    def gid(i: int, j: int, k: int) -> int:
        return i + n * (j + n * k)

    elem_dofs: list[np.ndarray] = []
    elem_mats: list[np.ndarray] = []
    for k in range(n - 1):
        for j in range(n - 1):
            for i in range(n - 1):
                nodes = [gid(i + dx, j + dy, k + dz)
                         for dx, dy, dz in _CORNERS]
                dofs = np.array([[3 * g, 3 * g + 1, 3 * g + 2]
                                 for g in nodes]).ravel()
                elem_dofs.append(dofs)
                elem_mats.append(pr[k] * pr[j] * pr[i] * k_ref)
    # clamp the z = 0 face: ghost springs on all three components
    for j in range(n):
        for i in range(n):
            for c in range(3):
                elem_dofs.append(np.array([3 * gid(i, j, 0) + c]))
                elem_mats.append(np.array([[spring]]))
    return from_lists(elem_dofs, elem_mats)


def get_input(args: str = "") -> ElementMesh:
    opt = _grid.parse_args(args, {
        "size": int, "weakScaling": int, "dim": int, "nu": float,
        "E": float, "kappa": tuple, "spring": float, "verbose": bool,
    })
    size = opt.get("size", 8)
    weak = opt.get("weakScaling", 1)
    dim = opt.get("dim", 2)
    nu = opt.get("nu", 0.3)
    e_mod = opt.get("E", 1.0)
    kappa_max, interp = opt.get("kappa", (1.0, ""))
    spring = opt.get("spring", 1.0)
    if dim == 3:
        return _get_input_3d(_grid.grid_size(size, weak, 3), nu, e_mod,
                             kappa_max, interp, spring)
    if dim != 2:
        raise ValueError("elasticity generator: --dim must be 2 or 3")

    n = _grid.grid_size(size, weak, 2)
    alpha, beta = _grid.init_kappa(n, interp, kappa_max)
    k_ref = q1_plane_strain_stiffness(e_mod, nu)

    def gid(i: int, j: int) -> int:
        return i + n * j

    elem_dofs: list[np.ndarray] = []
    elem_mats: list[np.ndarray] = []
    for j in range(n - 1):
        for i in range(n - 1):
            nodes = [gid(i, j), gid(i + 1, j), gid(i, j + 1),
                     gid(i + 1, j + 1)]
            dofs = np.array([[2 * g, 2 * g + 1] for g in nodes]).ravel()
            kap = (_grid.compute_kappa(interp, alpha, i + 0.5, beta)
                   * _grid.compute_kappa(interp, alpha, j + 0.5, beta))
            elem_dofs.append(dofs)
            elem_mats.append(kap * k_ref)
    # clamp the bottom face (j = 0): ghost springs on both components
    for i in range(n):
        for c in (0, 1):
            elem_dofs.append(np.array([2 * gid(i, 0) + c]))
            elem_mats.append(np.array([[spring * e_mod]]))
    return from_lists(elem_dofs, elem_mats)
