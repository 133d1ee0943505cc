"""Op ``resolve`` on the structured path: the preconditioner set up
once, as ``solve_structured`` sets it up; each op one float64 refined
solve of a given b, from the efficient hybrid's deflated guess Q b as
``solve_structured`` starts it.

The port has no single entry that sets up once and solves a given b, so
this file composes one from the functions ``solve_structured`` calls
(its inner cap of 2000 iterations, its Krylov type, its x0).
"""

import dataclasses

import torch
from geneo4petsc_tpu_torch.krylov import refine
from geneo4petsc_tpu_torch.structured import solve as ssolve
from geneo4petsc_tpu_torch.structured.decompose import StructuredDecomposition
from geneo4petsc_tpu_torch.structured.geneo import setup_structured
from geneo4petsc_tpu_torch.structured.grid import global_stencil

from g4pbench.program import (OpResult, Spanned, StructuredProgram,
                              float32_solve)


class Resolve(StructuredProgram):
    makes_rhs = False

    def __init__(self, cfg, field, device):
        super().__init__(cfg, field, device)
        sd = StructuredDecomposition(self.grid, self.boxes, self.overlap)
        self.pc, self.stats = setup_structured(
            sd, self.geneo, b=None, dtype=self.dtype, device=device)
        self.ksp_type = self.ksp.type if self.ksp.type in ("cg", "gmres") \
            else "cg"
        self.inner_max_it = int(min(self.ksp.max_it, 2000))
        self.inner = ssolve.make_structured_inner(
            self.pc, self.inner_max_it, self.ksp_type)
        self.gop64 = global_stencil(self.grid, torch.float64, device)
        self.sync()

    def _solve(self, b, pc, inner, solve) -> OpResult:
        x0 = pc.apply_q(b.to(self.dtype)).double() \
            if self.geneo.eff_hybrid else None
        ref = solve(self.gop64, b, inner, tol=self.tol, x0=x0)
        return OpResult(x=ref.x, inner=ref.inner_its, outer=ref.outer_its,
                        converged=bool(ref.converged))

    def op(self, b) -> OpResult:
        return self._solve(b, self.pc, self.inner,
                           refine.refined_solve_device)

    def control_op(self, b) -> OpResult:
        return self._solve(b, self.pc, self.inner, float32_solve)

    def traced_op(self):
        """The op with spans around the preconditioner's apply, its
        level-1 solves and every float32 stencil product."""
        pc = dataclasses.replace(
            self.pc, gop=Spanned(self.pc.gop, "matvec32", "matvec"),
            l1=Spanned(self.pc.l1, "l1_solve", "solve"))
        inner = ssolve.make_structured_inner(
            Spanned(pc, "pc_apply", "apply"), self.inner_max_it,
            self.ksp_type)
        return lambda b: self._solve(b, pc, inner,
                                     refine.refined_solve_device)

    def release(self) -> None:
        del self.pc, self.inner, self.gop64


def build(cfg, field, device):
    return Resolve(cfg, field, device)
