"""The port stands alone: no module of geneo4petsc_tpu_torch and not
chip_smoke.py imports JAX or the JAX package, at import time or inside a
function."""

import ast
import os
import subprocess
import sys

import pytest

from _time_limit import wait_s

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "geneo4petsc_tpu_torch")
BLOCKED = ("jax", "jaxlib", "geneo4petsc_tpu")

_IMPORT_ALL = f"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocked())
import geneo4petsc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    geneo4petsc_tpu_torch.__path__, "geneo4petsc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
assert not bad, bad
print(len(names))
"""


def test_every_module_imports_with_jax_blocked(request):
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True,
                          timeout=wait_s(request.node),
                          check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 50


def _sources():
    files = [os.path.join(root, f) for root, _, fs in os.walk(PACKAGE)
             for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", _sources(),
                         ids=[os.path.relpath(p, REPO) for p in _sources()])
def test_no_import_statement_names_jax(path):
    """Also the imports inside functions, which the import test does not
    run."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, \
                f"{path}:{node.lineno} imports {name}"


_IMPORT_ONE = f"""
import importlib, importlib.abc, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocked())
importlib.import_module(sys.argv[1])
bad = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}]
assert not bad, bad
"""


@pytest.mark.parametrize("module", [
    "geneo4petsc_tpu_torch.structured.elastic", "geneo4petsc_tpu_torch.api",
    "geneo4petsc_tpu_torch.utils.check", "geneo4petsc_tpu_torch.utils.debug",
    "geneo4petsc_tpu_torch.utils.checkpoint",
    "geneo4petsc_tpu_torch.structured.blockmode",
    "geneo4petsc_tpu_torch.structured.sharded",
    "geneo4petsc_tpu_torch.parallel.multiproc",
    "geneo4petsc_tpu_torch.parallel.sharded",
    "geneo4petsc_tpu_torch.parallel.dist",
    "geneo4petsc_tpu_torch.parallel.probes",
    "geneo4petsc_tpu_torch.utils.roofline",
    "geneo4petsc_tpu_torch.perf.measure_coarse"])
def test_new_module_imports_alone_with_jax_blocked(module, request):
    """Each module of the elastic backend, the library surface, the block
    layout, the multi-rank layouts and the measuring tools imports on its
    own in a process where JAX cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=wait_s(request.node), check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
