"""Op ``resolve`` on the structured path for a grid given by its explicit
stencil arrays (the heat generator's lbd * Laplacian + Mass / dt): the
op of ``systems/structured.resolve.py`` — the preconditioner set up once
as ``solve_structured`` sets it up, each op one float64 refined solve of
a given b from its x0, inner cap and Krylov type — on a
``StructuredGrid`` built through its public constructor from the
field's ``edge_off``, ``edge_diag`` and ``bc_val``.

The traced op adds spans inside the level-1 solve: ``l1_solve`` around
the level-1 solver's ``solve`` and, on the inexact route, ``l1_fdm``
around the surrogate FDM that preconditions its PCG.  ``counters()``
are the PCG local solver's class totals; over the window only level-1
solves run, so they count level-1 work alone.
"""

import dataclasses
import sys
from pathlib import Path

from geneo4petsc_tpu_torch.krylov import refine
from geneo4petsc_tpu_torch.structured import solve as ssolve
from geneo4petsc_tpu_torch.structured.grid import StructuredGrid

from g4pbench.program import Spanned, StructuredProgram
from g4pbench.spec import load_module

_kappa_resolve = load_module(
    Path(__file__).resolve().with_name("structured.resolve.py"),
    "g4pbench_system_structured_resolve")


class ExplicitProgram(StructuredProgram):
    """The structured program with the field's explicit stencil arrays in
    place of its kappa-derived stencil."""

    def __init__(self, cfg, field, device):
        super().__init__(cfg, field, device)
        self.grid = StructuredGrid(
            shape=tuple(field["shape"]), kappa=self.grid.kappa,
            inp_eps=float(cfg["inp_eps"]), dim=int(field["dim"]),
            edge_off_=tuple(field["edge_off"]),
            edge_diag_=tuple(field["edge_diag"]), bc_val_=field["bc_val"])


class Resolve(_kappa_resolve.Resolve, ExplicitProgram):
    """``structured.resolve``'s op; its set-up runs on the grid that
    ``ExplicitProgram`` (next in the method order) builds."""

    def __init__(self, cfg, field, device):
        super().__init__(cfg, field, device)
        pc, st = self.pc, self.stats
        print(f"[system] level-1 solver {type(pc.l1).__name__} (exact "
              f"{pc.l1_exact}), lvl {self.geneo.lvl1},{self.geneo.lvl2}, "
              f"dim_e {pc.dim_e} (a box {int(st.real_dim_e.min())}-"
              f"{int(st.real_dim_e.max())}), shift-invert PCG by pencil "
              f"(solves, iterations) "
              f"{getattr(st, 'shift_invert_pcg', None)}", file=sys.stderr)

    def traced_op(self):
        """The op with spans around the preconditioner's apply, its
        level-1 solves, the surrogate FDM inside them and every float32
        stencil product."""
        l1 = self.pc.l1
        if hasattr(l1, "pre"):
            l1 = dataclasses.replace(l1, pre=Spanned(l1.pre, "l1_fdm",
                                                     "solve"))
        pc = dataclasses.replace(
            self.pc, gop=Spanned(self.pc.gop, "matvec32", "matvec"),
            l1=Spanned(l1, "l1_solve", "solve"))
        inner = ssolve.make_structured_inner(
            Spanned(pc, "pc_apply", "apply"), self.inner_max_it,
            self.ksp_type)
        return lambda b: self._solve(b, pc, inner,
                                     refine.refined_solve_device)


def build(cfg, field, device):
    return Resolve(cfg, field, device)
