"""What the system files (``systems/<program>.<op>.py``) share: an op's
result, spans around a program object's method, options set from a
configuration, the control's float32 solve, and the structured
program's grid and options.

A system file exposes ``build(cfg, field, device)``, which returns the
system under test with:

* ``makes_rhs`` — True where an op makes its own right-hand side (the
  configuration's manufactured b, x = 1..n), False where it solves the
  b the runner hands it;
* ``op(b)`` — one op, returning an ``OpResult``;
* ``traced_op()`` — the same op with spans (``tracing.span``) around the
  calls the per-layer metrics read;
* ``control_op(b)`` — the control of the correctness check: the
  program's own path one precision below the configuration's;
* ``counters()`` — the program's running counts (name -> int), read
  before and after the window;
* ``release()`` — free the program's state before the reference
  check.

The harness calls the program's functions through their modules at call
time.  Spans sit in the system files and here only, around calls into
the program, and only on the traced ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import tracing

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class OpResult:
    x: object            # float64 solution: a host array or a device tensor
    inner: int
    outer: int
    converged: bool
    timers: dict | None = None


def set_options(obj, values: dict) -> None:
    """Set the configuration's option values on an options dataclass
    (nested groups by attribute); an unknown key raises."""
    for k, v in values.items():
        if not hasattr(obj, k):
            raise KeyError(f"{type(obj).__name__} has no option {k!r}")
        if isinstance(v, dict):
            set_options(getattr(obj, k), v)
        else:
            setattr(obj, k, v)


class Spanned:
    """``obj`` with its method ``method`` run inside ``tracing.span(span)``;
    every other attribute is the object's own."""

    def __init__(self, obj, span: str, method: str):
        self._obj, self._span, self._method = obj, span, method

    def __getattr__(self, name):
        value = getattr(self._obj, name)
        if name != self._method:
            return value

        def spanned(*args, **kw):
            with tracing.span(self._span):
                return value(*args, **kw)

        return spanned


def float32_solve(op64, b64, inner, tol, x0=None, **_):
    """The control, in the place of ``krylov.refine.refined_solve_device``
    and with its signature: the program's float32 inner solver asked for
    the whole tolerance, with no float64 refinement (b scaled by a power
    of two, as the refinement scales it).  It reports convergence, as a
    program that trusted its float32 residual would."""
    from geneo4petsc_tpu_torch.krylov.refine import RefinedResult

    s = torch.exp2(torch.ceil(torch.log2(b64.abs().max())))
    res = inner((b64 / s).to(torch.float32), tol)
    x = res.x.double() * s
    return RefinedResult(x=x, outer_its=0, inner_its=int(res.its),
                         true_res=float("nan"), converged=True, history=[])


class StructuredProgram:
    """A configuration on the structured path of ``geneo4petsc_tpu_torch``:
    its grid (the benchmark's own kappa field, through the public
    ``StructuredGrid`` constructor), options and precision plan."""

    def __init__(self, cfg: dict, field: dict, device: torch.device):
        from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
        from geneo4petsc_tpu_torch.structured.grid import StructuredGrid

        self.device = device
        self.grid = StructuredGrid(
            shape=tuple(field["shape"]), kappa=np.array(field["kappa"]),
            inp_eps=float(cfg["inp_eps"]), dim=int(field["dim"]),
            separable_hint=bool(field["separable"]))
        dec = cfg["decomposition"]
        self.boxes, self.overlap = tuple(dec["boxes"]), int(dec["overlap"])
        self.geneo = GenEOOptions()
        set_options(self.geneo, cfg["geneo"])
        self.ksp = KSPOptions()
        set_options(self.ksp, cfg["ksp"])
        prec = cfg["precision"]
        if prec["refine_dtype"] != "float64":
            raise ValueError("the structured path refines in float64")
        self.dtype = DTYPES[prec["pc_dtype"]]
        self.tol = float(cfg["accuracy"]["tol"])

    def counters(self) -> dict:
        """The program's PCG local solver: solves and iterations so
        far."""
        from geneo4petsc_tpu_torch.structured.solvers import PCGSolver

        return {"pcg_solves": PCGSolver.solves,
                "pcg_iterations": PCGSolver.iterations}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        pass
