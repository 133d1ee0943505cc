"""Q1 hexahedral elasticity: the element stiffness shared by the 3-D
elasticity generator (models/elasticity.py).

The structured elastic backend (Q1 with 3 DOF per node on the box
decomposition, ROADMAP Queue 1 item 18) is not ported yet; this module
holds only the element it will build on.
"""

from __future__ import annotations

import numpy as np


def q1_hex_stiffness(e_mod: float, nu: float) -> np.ndarray:
    """24x24 stiffness of a unit Q1 hexahedron (2x2x2 Gauss), isotropic.

    Node order n = dx + 2*dy + 4*dz (corner offsets in {0,1}^3), DOF order
    (ux, uy, uz) per node: dof = 3n + c."""
    lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e_mod / (2 * (1 + nu))
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[np.arange(3), np.arange(3)] = lam + 2 * mu
    d[3:, 3:] = mu * np.eye(3)
    # corner signs in reference coords [-1, 1]^3
    xs = np.array([(-1) ** (1 + (n >> 0 & 1)) for n in range(8)], float)
    ys = np.array([(-1) ** (1 + (n >> 1 & 1)) for n in range(8)], float)
    zs = np.array([(-1) ** (1 + (n >> 2 & 1)) for n in range(8)], float)
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    k = np.zeros((24, 24))
    for xi in gp:
        for eta in gp:
            for zeta in gp:
                dn_dxi = 0.125 * xs * (1 + ys * eta) * (1 + zs * zeta)
                dn_deta = 0.125 * ys * (1 + xs * xi) * (1 + zs * zeta)
                dn_dzeta = 0.125 * zs * (1 + xs * xi) * (1 + ys * eta)
                # unit cube: J = diag(1/2), det J = 1/8
                dn = np.stack([dn_dxi, dn_deta, dn_dzeta]) * 2.0
                b = np.zeros((6, 24))
                b[0, 0::3] = dn[0]
                b[1, 1::3] = dn[1]
                b[2, 2::3] = dn[2]
                b[3, 0::3] = dn[1]
                b[3, 1::3] = dn[0]
                b[4, 1::3] = dn[2]
                b[4, 2::3] = dn[1]
                b[5, 0::3] = dn[2]
                b[5, 2::3] = dn[0]
                k += (b.T @ d @ b) / 8.0
    return 0.5 * (k + k.T)


_CORNERS = [(n & 1, (n >> 1) & 1, (n >> 2) & 1) for n in range(8)]
