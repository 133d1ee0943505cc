"""PETSc-compatible ASCII output formatting (the formats the CLI's
default and ``--verbose`` output use).

The reference's stdout protocol is a de facto API: `plot.py` parses INFO/
TIME token positions and the golden refs freeze the exact dump formats
(PETSC_VIEWER_ASCII_COMMON MatView/VecView).  This module reproduces those
formats so logs remain tool-compatible.
"""

from __future__ import annotations

import numpy as np


def g(x: float) -> str:
    """PETSc %g-style scalar: integral values print with a trailing dot
    ('2.', '-1.', '25.'), others like '0.5', '1.23457e-05'."""
    if x == 0:
        return "0."
    s = f"{x:g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += "."
    return s


def format_vec(v: np.ndarray, n_proc: int, name: str | None = None) -> str:
    """VecView in ASCII_COMMON format (the 'The vector B is:' blocks)."""
    lines = []
    if name:
        lines.append(f"The vector {name} is:")
    lines.append(f"Vec Object: {n_proc} MPI processes")
    lines.append("  type: mpi")
    for x in v:
        lines.append(g(float(x)))
    return "\n".join(lines) + "\n"


def format_seqaij(block: np.ndarray, tol: float = 0.0) -> str:
    """One sequential AIJ block ('row i: (j, v)  ...')."""
    lines = ["  Mat Object: 1 MPI processes", "    type: seqaij"]
    n = block.shape[0]
    for i in range(n):
        entries = []
        for j in range(block.shape[1]):
            v = block[i, j]
            if v != 0.0 or i == j:  # stored pattern includes the diagonal
                entries.append(f"({j}, {g(float(v))}) ")
        lines.append("row " + str(i) + ": " + " ".join(entries))
    return "\n".join(lines)


def format_matis(blocks: list[np.ndarray], n_proc: int,
                 name: str | None = None) -> str:
    """MatView of a MatIS: the per-domain unassembled local blocks."""
    lines = []
    if name:
        lines.append(f"The matrix {name} is:")
    lines.append(f"Mat Object: {n_proc} MPI processes")
    lines.append("  type: is")
    for b in blocks:
        lines.append(format_seqaij(b))
    return "\n".join(lines) + "\n"


def format_aij_global(a_dense: np.ndarray, n_proc: int,
                      name: str | None = None) -> str:
    """MatView of an assembled (MPI)AIJ matrix."""
    lines = []
    if name:
        lines.append(f"The matrix {name} is:")
    lines.append(f"Mat Object: {n_proc} MPI processes")
    lines.append("  type: mpiaij")
    for i in range(a_dense.shape[0]):
        entries = [f"({j}, {g(float(a_dense[i, j]))}) "
                   for j in range(a_dense.shape[1]) if a_dense[i, j] != 0.0]
        lines.append("row " + str(i) + ": " + " ".join(entries))
    return "\n".join(lines) + "\n"
