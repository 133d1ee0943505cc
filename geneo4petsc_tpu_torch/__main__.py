"""`python -m geneo4petsc_tpu_torch ...` — the geneo4PETSc executable role
(geneo4PETSc.cpp:main): same flag surface, same INFO/TIME stdout
protocol, plus ``--device cpu|cuda``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
