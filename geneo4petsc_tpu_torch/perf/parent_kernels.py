"""The kernel wrappers of an earlier commit, for timing beside this
tree's.

``load(parent_dir)`` imports ``geneo4petsc_tpu_torch/ops/local_kernels.py``
of the checkout at ``parent_dir`` (made with ``git archive``; only its
``geneo4petsc_tpu_torch/ops/`` is needed) as a package of its own, so
that its wrappers build and launch that checkout's kernels through that
checkout's host code.  Returns the module: its ``fused_local_solve`` and
``block_matvec`` have the signatures of this tree's.
"""

from __future__ import annotations

import importlib.util
import sys


def load(parent_dir: str):
    ops = f"{parent_dir}/geneo4petsc_tpu_torch/ops"
    name = "g4p_parent_ops"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, f"{ops}/__init__.py", submodule_search_locations=[ops])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.local_kernels")
