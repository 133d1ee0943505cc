"""The plain reference of the structured configurations: the 7-point
operator of a kappa field, and the residual that judges a solution.

The operator follows the upstream generator's element formula
(geneo4PETSc tst/laplacian/laplacian.cpp:118-189 with
laplacianServices.cpp:41-94): along every active axis, each edge
(v, v + e) is a two-node element kappa(v) * [[1 + eps, -1], [-1, 1 + eps]]
with kappa taken at the edge's lower endpoint, and each node on the
lower face of the last active axis carries a one-node Dirichlet ghost
kappa(v) * (1 + eps).  The product is summed element by element, in
float64, straight from kappa: no assembled diagonal, no field of the
measured program.
"""

from __future__ import annotations

import numpy as np
import torch


def build(field: dict, cfg: dict, device="cpu") -> "Kappa7Point":
    """The operator of a field made by ``fields/<kind>.py`` (its
    ``kappa`` and ``dim``) under the configuration's ``inp_eps``."""
    return Kappa7Point(field["kappa"], field["dim"], cfg["inp_eps"], device)


class Kappa7Point:
    """A = sum of the elements above; ``matvec`` on flat float64
    vectors with node id x + nx * (y + ny * z)."""

    def __init__(self, kappa: np.ndarray, dim: int, inp_eps: float,
                 device="cpu"):
        self.kappa = torch.as_tensor(np.asarray(kappa, np.float64),
                                     device=device)
        self.dim = int(dim)
        self.eps = float(inp_eps)

    @property
    def n(self) -> int:
        return self.kappa.numel()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kappa
        u = x.to(k.device, torch.float64).reshape(k.shape)
        y = torch.zeros_like(u)
        e1 = 1.0 + self.eps
        for ax in range(3):
            m = k.shape[ax]
            if m == 1:
                continue
            c = k.narrow(ax, 0, m - 1)
            lo, hi = u.narrow(ax, 0, m - 1), u.narrow(ax, 1, m - 1)
            y.narrow(ax, 0, m - 1).add_(c * (e1 * lo - hi))
            y.narrow(ax, 1, m - 1).add_(c * (e1 * hi - lo))
        bc = 3 - self.dim               # array axis of the last active axis
        y.narrow(bc, 0, 1).add_(e1 * k.narrow(bc, 0, 1) * u.narrow(bc, 0, 1))
        return y.reshape(-1)

    def relative_residual(self, x, b: torch.Tensor) -> float:
        """||b - A x|| / ||b|| in float64."""
        x = torch.as_tensor(x).to(self.kappa.device, torch.float64)
        b = b.to(self.kappa.device, torch.float64)
        return float(torch.linalg.vector_norm(b - self.matvec(x))
                     / torch.linalg.vector_norm(b))
