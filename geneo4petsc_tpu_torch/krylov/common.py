"""Shared Krylov infrastructure: PETSc-compatible stopping tests and
converged-reason taxonomy (values match PETSc's KSPConvergedReason enum;
strings match getKSPConvergedReason, src/geneo4PETSc.cpp:1013-1040).

The Krylov loops run in Python; each iteration brings its few scalars to
the host once (``host_scalars``) for the convergence test."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# --- KSPConvergedReason (PETSc numeric values) ---
CONVERGED_ITERATING = 0
CONVERGED_RTOL_NORMAL = 1
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_ITS = 4
CONVERGED_CG_NEG_CURVE = 5
CONVERGED_CG_CONSTRAINED = 6
CONVERGED_STEP_LENGTH = 7
CONVERGED_HAPPY_BREAKDOWN = 8
CONVERGED_ATOL_NORMAL = 9
DIVERGED_NULL = -2
DIVERGED_ITS = -3
DIVERGED_DTOL = -4
DIVERGED_BREAKDOWN = -5
DIVERGED_BREAKDOWN_BICG = -6
DIVERGED_NONSYMMETRIC = -7
DIVERGED_INDEFINITE_PC = -8
DIVERGED_NANORINF = -9
DIVERGED_INDEFINITE_MAT = -10
DIVERGED_PC_FAILED = -11

_REASON_STRINGS = {
    CONVERGED_ITERATING: "KSP_CONVERGED_ITERATING",
    CONVERGED_RTOL_NORMAL: "KSP_CONVERGED_RTOL_NORMAL",
    CONVERGED_ATOL_NORMAL: "KSP_CONVERGED_ATOL_NORMAL",
    CONVERGED_RTOL: "KSP_CONVERGED_RTOL",
    CONVERGED_ATOL: "KSP_CONVERGED_ATOL",
    CONVERGED_ITS: "KSP_CONVERGED_ITS",
    CONVERGED_CG_NEG_CURVE: "KSP_CONVERGED_CG_NEG_CURVE",
    CONVERGED_CG_CONSTRAINED: "KSP_CONVERGED_CG_CONSTRAINED",
    CONVERGED_STEP_LENGTH: "KSP_CONVERGED_STEP_LENGTH",
    CONVERGED_HAPPY_BREAKDOWN: "KSP_CONVERGED_HAPPY_BREAKDOWN",
    DIVERGED_NULL: "KSP_DIVERGED_NULL",
    DIVERGED_ITS: "KSP_DIVERGED_ITS",
    DIVERGED_DTOL: "KSP_DIVERGED_DTOL",
    DIVERGED_BREAKDOWN: "KSP_DIVERGED_BREAKDOWN",
    DIVERGED_BREAKDOWN_BICG: "KSP_DIVERGED_BREAKDOWN_BICG",
    DIVERGED_NONSYMMETRIC: "KSP_DIVERGED_NONSYMMETRIC",
    DIVERGED_INDEFINITE_PC: "KSP_DIVERGED_INDEFINITE_PC",
    DIVERGED_NANORINF: "KSP_DIVERGED_NANORINF",
    DIVERGED_INDEFINITE_MAT: "KSP_DIVERGED_INDEFINITE_MAT",
    DIVERGED_PC_FAILED: "KSP_DIVERGED_PC_FAILED",
}


def reason_string(reason: int) -> str:
    return _REASON_STRINGS.get(int(reason), "")


@dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor
    its: int             # completed iterations
    reason: int          # KSPConvergedReason value
    rnorm: float         # final residual norm (per norm_type)
    history: torch.Tensor  # [max_it+1] float64 residual norms (nan-padded)

    @property
    def converged(self) -> bool:
        return self.reason >= 0


class Inner:
    """The reductions of the Krylov loops over vectors that one process
    holds whole: torch's own dot, 2-norm, max|.| and basis product."""

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a, b)

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(a)

    def amax(self, a: torch.Tensor) -> torch.Tensor:
        return a.abs().max()

    def basis_dot(self, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """[k, n] @ [n]: the inner products of w with k basis vectors."""
        return v @ w


LOCAL = Inner()


class DistInner(Inner):
    """The same reductions over vectors split across the ranks of a
    process group: each rank reduces its own rows, one ``all_reduce``
    adds (or maxes) the partials.  The 2-norm is sqrt of the summed
    squares of the local norms; on one rank that is the local norm
    itself (sqrt(fl(n*n)) = n in binary floating point), so a
    one-rank run keeps the single-process bits."""

    def __init__(self, group=None):
        self.group = group

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        return t

    def dot(self, a, b):
        return self._sum(torch.dot(a, b))

    def norm(self, a):
        n = torch.linalg.vector_norm(a)
        return torch.sqrt(self._sum(n * n))

    def amax(self, a):
        import torch.distributed as dist
        m = a.abs().max() if a.numel() else a.new_zeros(())
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m

    def basis_dot(self, v, w):
        return self._sum(v @ w)

    def any(self, flag: torch.Tensor) -> bool:
        """A boolean that is true on any rank."""
        import torch.distributed as dist
        t = flag.to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t)


def host_scalars(*scalars: torch.Tensor) -> list[float]:
    """0-d tensors -> Python floats with one device synchronization."""
    return torch.stack(scalars).tolist()


def history_tensor(values: list[float], max_it: int) -> torch.Tensor:
    """Residual norms by iteration, nan-padded to max_it + 1 entries."""
    h = torch.full((max_it + 1,), math.nan, dtype=torch.float64)
    h[:len(values)] = torch.tensor(values, dtype=torch.float64)
    return h


def converged_default(rnorm: float, bnorm: float, it: int, rtol: float,
                      atol: float, dtol: float, max_it: int,
                      rnorm0: float | None = None) -> int:
    """KSPConvergedDefault: rnorm <= max(rtol*bnorm, atol) converges (RTOL if
    the rtol branch is the active bound, else ATOL); rnorm >= dtol*rnorm0
    diverges (DTOL — PETSc scales divtol by the INITIAL residual norm, which
    differs from bnorm for nonzero initial guesses); hitting max_it diverges
    (ITS).  Returns reason (0 while iterating)."""
    if rnorm0 is None:
        rnorm0 = bnorm
    if math.isnan(rnorm) or math.isinf(rnorm):
        return DIVERGED_NANORINF
    rtest = rtol * bnorm
    if rnorm <= max(rtest, atol):
        return CONVERGED_RTOL if rtest > atol else CONVERGED_ATOL
    if rnorm >= dtol * rnorm0 and it > 0:
        return DIVERGED_DTOL
    if it >= max_it:
        return DIVERGED_ITS
    return CONVERGED_ITERATING
