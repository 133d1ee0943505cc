"""The plain reference of the heat configurations: the operator of one
implicit-Euler heat step, and the residual that judges a solution.

The operator follows the upstream heat generator's element formula
(geneo4PETSc tst/heat/heat.cpp: lbd * Laplacian + Mass / dt on the
laplacian generator's grid): along every active axis, each edge
(v, v + e) is a two-node element
lbd * kappa(v) * [[1 + eps, -1], [-1, 1 + eps]] + [[1/3, 1/6], [1/6, 1/3]] / dt
with kappa taken at the edge's lower endpoint, and each node on the
lower face of the last active axis carries the one-node ghost
lbd * kappa(v) * (1 + eps) + (1/3) / dt.  The product is summed element
by element, in float64, straight from kappa, lbd, dt and eps: no
assembled diagonal, no stencil array of the field, no field of the
measured program.
"""

from __future__ import annotations

import numpy as np
import torch


def build(field: dict, cfg: dict, device="cpu") -> "Heat7Point":
    """The operator of a field made by ``fields/heat.py`` (its ``kappa``,
    ``dim``, ``lbd`` and ``dt``) under the configuration's ``inp_eps``."""
    # nothing here may run at a lower precision than float64's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Heat7Point(field["kappa"], field["dim"], cfg["inp_eps"],
                      field["lbd"], field["dt"], device)


class Heat7Point:
    """A = sum of the elements above; ``matvec`` on flat float64
    vectors with node id x + nx * (y + ny * z)."""

    def __init__(self, kappa: np.ndarray, dim: int, inp_eps: float,
                 lbd: float, dt: float, device="cpu"):
        self.kappa = torch.as_tensor(np.asarray(kappa, np.float64),
                                     device=device)
        self.dim = int(dim)
        self.eps = float(inp_eps)
        self.lbd, self.dt = float(lbd), float(dt)

    @property
    def n(self) -> int:
        return self.kappa.numel()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kappa
        u = x.to(k.device, torch.float64).reshape(k.shape)
        y = torch.zeros_like(u)
        e1 = 1.0 + self.eps
        m_d, m_o = 1.0 / (3.0 * self.dt), 1.0 / (6.0 * self.dt)
        for ax in range(3):
            m = k.shape[ax]
            if m == 1:
                continue
            c = self.lbd * k.narrow(ax, 0, m - 1)
            lo, hi = u.narrow(ax, 0, m - 1), u.narrow(ax, 1, m - 1)
            y.narrow(ax, 0, m - 1).add_(c * (e1 * lo - hi)
                                        + (m_d * lo + m_o * hi))
            y.narrow(ax, 1, m - 1).add_(c * (e1 * hi - lo)
                                        + (m_d * hi + m_o * lo))
        bc = 3 - self.dim               # array axis of the last active axis
        ghost = self.lbd * e1 * k.narrow(bc, 0, 1) + m_d
        y.narrow(bc, 0, 1).add_(ghost * u.narrow(bc, 0, 1))
        return y.reshape(-1)

    def relative_residual(self, x, b: torch.Tensor) -> float:
        """||b - A x|| / ||b|| in float64."""
        x = torch.as_tensor(x).to(self.kappa.device, torch.float64)
        b = b.to(self.kappa.device, torch.float64)
        return float(torch.linalg.vector_norm(b - self.matvec(x))
                     / torch.linalg.vector_norm(b))
