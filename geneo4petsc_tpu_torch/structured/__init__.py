"""Structured-grid GenEO backend — the large-scale (10M+ DOF) path.

The generic path (assembly/, precond/geneo.py) stores each subdomain as a
dense [n_max, n_max] block: exact MatIS semantics, but O(n_loc^2) memory
caps it near 1M DOF.  The reference escapes that wall with MUMPS sparse
factorizations (src/geneo.cpp:94-124) and sparse SLEPc operators
(:626-780).  This package is the equivalent for structured grids:
subdomains are boxes, local operators are 7-point stencils, the halo
exchange is block-grid shifts, and the per-domain direct solves are fast
diagonalizations (separable coefficients) or block-tridiagonal Schur
factorizations over grid planes.
"""

from .grid import (StructuredGrid, heat_grid, inclusion_grid,
                   laplacian_grid)

__all__ = ["StructuredGrid", "heat_grid", "inclusion_grid",
           "laplacian_grid"]
