"""Nothing a run loads is JAX or the JAX package, and the plain
reference loads nothing of the measured package."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "geneo4petsc_tpu"}


def _modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = _modules(f"""
import json, runpy, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}, {str(BENCH / "tests")!r}]
runpy.run_path({str(BENCH / "run.py")!r})
from g4pbench import runner
from conftest import shrink
for cell in ("lap10m.fresh", "lap10m.reuse"):
    runner.run_cell(runner.BENCH_DIR.parent, cell, 5, 0.2, True, "cpu",
                    time.perf_counter(), config_override=shrink(12))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "geneo4petsc_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = _modules(f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}]
import reference.kappa_7point, reference.roofline
import reference.fields.laplacian
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "reference" in top
    assert not top & (FORBIDDEN | {"geneo4petsc_tpu_torch", "g4pbench"})
