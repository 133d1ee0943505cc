"""Element-list problem definition format.

Replicates the reference input layer (src/geneo4PETSc.cpp:75-194):

* One element per line: a list of DOF ids, then optionally ``-`` followed by a
  dense row-major n x n matrix.
* If no matrix is given, a default one is built from ``inp_eps``:
  diag = 1+eps, off-diag = -1/(n-1)  (readLineFile, geneo4PETSc.cpp:130-138).
* Lines starting with ``%`` or ``#`` (after stripping leading blanks) are
  comments; empty lines are skipped.
* Node ids must form a dense range 0..n-1 (validity checks :171-191).

RHS file format (createB, geneo4PETSc.cpp:840-860): one ``idx [val]`` per
line, default val 1.0; unset entries are 0.  Without an RHS file a
manufactured solution X = (1, 2, 3, ...) is used and B = A X
(geneo4PETSc.cpp:815-834) so the exact solution is known.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class ElementMesh:
    """A problem definition: elements = sets of DOFs + dense sub-matrices.

    CSR layout identical to the reference ABI (elemPtr/elemIdx/elemSubMat).
    """

    n_nodes: int
    elem_ptr: np.ndarray            # [n_elems+1] int64
    elem_idx: np.ndarray            # [elem_ptr[-1]] int64
    elem_mats: list = field(default_factory=list)  # list of (k,k) float64

    @property
    def n_elems(self) -> int:
        return len(self.elem_ptr) - 1

    def elem_nodes(self, e: int) -> np.ndarray:
        return self.elem_idx[self.elem_ptr[e]:self.elem_ptr[e + 1]]

    @property
    def nnz_estimate(self) -> int:
        """Upper bound on assembled nnz (sum of k^2 over elements)."""
        sizes = np.diff(self.elem_ptr)
        return int(np.sum(sizes * sizes))

    def validate(self) -> None:
        if self.n_nodes == 0 or self.n_elems == 0:
            raise ValueError("Error: empty input")
        seen = np.unique(self.elem_idx)
        if seen[0] < 0 or seen[-1] + 1 != self.n_nodes or len(seen) != self.n_nodes:
            raise ValueError(
                f"Error: bad node set ({seen[-1] + 1}/{self.n_nodes})")
        if len(self.elem_mats) != self.n_elems:
            raise ValueError("Error: bad input sub matrices")
        for e in range(self.n_elems):
            k = self.elem_ptr[e + 1] - self.elem_ptr[e]
            if self.elem_mats[e].shape != (k, k):
                raise ValueError(f"Error: bad matrix ({e + 1}) in input")


def default_elem_mat(n_dof: int, inp_eps: float) -> np.ndarray:
    """Default elementary matrix (geneo4PETSc.cpp:130-138)."""
    if n_dof == 1:
        return np.array([[1.0 + inp_eps]], dtype=np.float64)
    alpha = -1.0 / (n_dof - 1)
    m = np.full((n_dof, n_dof), alpha, dtype=np.float64)
    np.fill_diagonal(m, 1.0 + inp_eps)
    return m


def from_lists(elem_dofs: Sequence[Sequence[int]],
               elem_mats: Sequence[np.ndarray] | None = None,
               inp_eps: float = 0.0001,
               n_nodes: int | None = None) -> ElementMesh:
    """Build an ElementMesh from per-element DOF lists (generator protocol)."""
    ptr = np.zeros(len(elem_dofs) + 1, dtype=np.int64)
    idx_parts = []
    mats = []
    for e, dofs in enumerate(elem_dofs):
        dofs = np.asarray(dofs, dtype=np.int64)
        ptr[e + 1] = ptr[e] + len(dofs)
        idx_parts.append(dofs)
        if elem_mats is not None and elem_mats[e] is not None:
            mats.append(np.asarray(elem_mats[e], dtype=np.float64).reshape(
                len(dofs), len(dofs)))
        else:
            mats.append(default_elem_mat(len(dofs), inp_eps))
    idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int64)
    if n_nodes is None:
        n_nodes = int(idx.max()) + 1 if len(idx) else 0
    mesh = ElementMesh(n_nodes=n_nodes, elem_ptr=ptr, elem_idx=idx,
                       elem_mats=mats)
    mesh.validate()
    return mesh


def _strip_comment(line: str) -> str:
    line = line.lstrip()
    if not line or line[0] in "%#":
        return ""
    return line


def read_input_file(path: str, inp_eps: float = 0.0001) -> ElementMesh:
    """Parse the element-list text format (readInputFile semantics)."""
    elem_dofs: list[np.ndarray] = []
    elem_mats: list[np.ndarray | None] = []
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw)
            if not line:
                continue
            tokens = line.split()
            dofs: list[int] = []
            vals: list[float] = []
            fill_dof = True
            for tok in tokens:
                if tok == "-":
                    fill_dof = False
                    continue
                if fill_dof:
                    try:
                        dofs.append(int(tok))
                    except ValueError:
                        pass  # reference silently skips unparsable tokens
                else:
                    try:
                        vals.append(float(tok))
                    except ValueError:
                        pass
            if not dofs:
                continue
            n = len(dofs)
            elem_dofs.append(np.asarray(dofs, dtype=np.int64))
            if vals:
                if len(vals) != n * n:
                    raise ValueError(
                        f"Error: bad matrix ({len(elem_dofs)}) in file {path}")
                elem_mats.append(np.asarray(vals).reshape(n, n))
            else:
                elem_mats.append(None)
    return from_lists(elem_dofs, elem_mats, inp_eps=inp_eps)


def read_rhs_file(path: str, n_dof: int) -> np.ndarray:
    """Parse the B-vector format (createB file branch)."""
    b = np.zeros(n_dof, dtype=np.float64)
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw)
            if not line:
                continue
            tokens = line.split()
            idx = int(tokens[0])
            val = float(tokens[1]) if len(tokens) > 1 else 1.0
            b[idx] = val  # INSERT_VALUES semantics
    return b


def manufactured_solution(n_dof: int) -> np.ndarray:
    """X = (1, 2, 3, ...) so that B = A X has a known solution."""
    return np.arange(1, n_dof + 1, dtype=np.float64)


def write_input_file(mesh: ElementMesh, path: str) -> None:
    """Write an ElementMesh in the reference text format."""
    with open(path, "w") as f:
        for e in range(mesh.n_elems):
            dofs = " ".join(str(d) for d in mesh.elem_nodes(e))
            mat = " ".join(repr(float(v)) for v in mesh.elem_mats[e].ravel())
            f.write(f"{dofs} - {mat}\n")
