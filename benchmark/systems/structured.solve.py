"""Op ``solve`` on the structured path: one whole ``solve_structured``
call — decomposition, the manufactured right-hand side (x = 1..n), the
preconditioner's set-up, the refined solve, x back on the host.  The
refinement takes the device route, the card's default, on every device,
so that a run on the CPU goes the card's way."""

from geneo4petsc_tpu_torch.structured import solve as ssolve
from geneo4petsc_tpu_torch.utils.timers import Timers

from g4pbench.program import (OpResult, StructuredProgram, float32_solve)


class Solve(StructuredProgram):
    makes_rhs = True

    def op(self, b=None) -> OpResult:
        timers = Timers()
        out = ssolve.solve_structured(
            self.grid, self.boxes, self.overlap, geneo=self.geneo,
            ksp=self.ksp, tol=self.tol, dtype=self.dtype, timers=timers,
            device=self.device, device_refine=True)
        return OpResult(x=out.x, inner=out.refined.inner_its,
                        outer=out.refined.outer_its,
                        converged=bool(out.converged),
                        timers=dict(timers.phases))

    def traced_op(self):
        return self.op

    def control_op(self, b=None) -> OpResult:
        """The whole solve with its float64 refinement replaced by the
        float32 inner solve (``program.float32_solve``)."""
        real = ssolve.refined_solve_device
        ssolve.refined_solve_device = float32_solve
        try:
            return self.op()
        finally:
            ssolve.refined_solve_device = real


def build(cfg, field, device):
    return Solve(cfg, field, device)
