"""PETSc-compatible output formats: the ASCII dumps of the CLI's default
and ``--verbose`` output, the Matlab exports of ``--debug mat`` and the
PetscViewerBinary files of ``--debug bin`` / ``-geneo_dbg bin``.

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


def format_vec_matlab(v: np.ndarray, name: str) -> str:
    """Matlab-format vector export (PETSC_VIEWER_ASCII_MATLAB role,
    src/geneo.cpp:66-68): `name = [ ... ];`."""
    lines = [f"%Vec Object: {name}", f"{name} = ["]
    lines += [f"{float(x):.16e}" for x in v]
    lines.append("];")
    return "\n".join(lines) + "\n"


def format_mat_matlab(a: np.ndarray, name: str) -> str:
    """Matlab-format sparse-matrix export: zeros/sparse triplet form."""
    lines = [f"%Mat Object: {name}",
             f"{name} = zeros({a.shape[0]},{a.shape[1]});"]
    nz = np.argwhere(a != 0.0)
    for i, j in nz:
        lines.append(f"{name}({i + 1},{j + 1}) = {float(a[i, j]):.16e};")
    return "\n".join(lines) + "\n"


# ---------------- PetscViewerBinary format (--debug bin, -geneo_dbg bin) ---

# Real PETSc binary classids (petscmat.h / petscvec.h): a reader built for
# PETSc (PetscViewerBinaryOpen + VecLoad/MatLoad) consumes these files.
VEC_FILE_CLASSID = 1211214
MAT_FILE_CLASSID = 1211216


def write_vec_bin(path: str, v: np.ndarray) -> None:
    """VecView to PETSc binary: int32-BE [classid, n] + f64-BE values."""
    v = np.asarray(v, np.float64)
    with open(path, "wb") as f:
        np.array([VEC_FILE_CLASSID, v.size], ">i4").tofile(f)
        v.astype(">f8").tofile(f)


def write_mat_bin(path: str, a, tol: float = 0.0) -> None:
    """MatView to PETSc binary (AIJ): int32-BE header [classid, m, n, nnz],
    per-row nonzero counts, column indices, then f64-BE values.

    `a` is a dense [m, n] array or a scipy CSR; dense inputs drop entries
    with |value| <= tol (the assembled-zero convention)."""
    import scipy.sparse as sp

    if sp.issparse(a):
        csr = a.tocsr()
    else:
        d = np.asarray(a, np.float64)
        mask = np.abs(d) > tol
        csr = sp.csr_matrix(np.where(mask, d, 0.0))
        csr.eliminate_zeros()
    m, n = csr.shape
    rownz = np.diff(csr.indptr).astype(">i4")
    with open(path, "wb") as f:
        np.array([MAT_FILE_CLASSID, m, n, csr.nnz], ">i4").tofile(f)
        rownz.tofile(f)
        csr.indices.astype(">i4").tofile(f)
        csr.data.astype(">f8").tofile(f)


def read_vec_bin(path: str) -> np.ndarray:
    """Read back a PETSc binary Vec (round-trip testing)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, ">i4", 2)
        assert head[0] == VEC_FILE_CLASSID, "not a PETSc Vec file"
        return np.fromfile(f, ">f8", head[1]).astype(np.float64)


def read_mat_bin(path: str):
    """Read back a PETSc binary AIJ Mat as scipy CSR."""
    import scipy.sparse as sp

    with open(path, "rb") as f:
        head = np.fromfile(f, ">i4", 4)
        assert head[0] == MAT_FILE_CLASSID, "not a PETSc Mat file"
        m, n, nnz = int(head[1]), int(head[2]), int(head[3])
        rownz = np.fromfile(f, ">i4", m).astype(np.int64)
        indices = np.fromfile(f, ">i4", nnz).astype(np.int32)
        data = np.fromfile(f, ">f8", nnz).astype(np.float64)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(rownz, out=indptr[1:])
    return sp.csr_matrix((data, indices, indptr), shape=(m, n))
