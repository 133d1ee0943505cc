"""End-to-end solves of the PyTorch port against the JAX package (the
pinned iteration counts of tst/golden/iteration_counts.json are held by
tests/test_torch_golden_*.py).

Tolerances: iteration counts and reasons are equal; solutions agree to
1e-6 relative, the size of a few rtol-converged Krylov steps' roundoff
differences between the two packages' summation orders."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from geneo4petsc_tpu import cli as jax_cli
from geneo4petsc_tpu.config import DriverOptions as JaxDriverOptions
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.solver import solve_mesh as jax_solve_mesh
from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.config import DriverOptions, GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.solver import solve_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARGS = "--size 12 --dim 2 --kappa 100. minmax"


def _opts(mod_geneo, mod_ksp, mod_drv, lvl1, lvl2, ksp_type, dls1):
    g = mod_geneo()
    g.lvl1, g.lvl2 = lvl1, lvl2
    g.dls1.type = dls1
    return (g, mod_ksp(type=ksp_type, rtol=1e-8),
            mod_drv(add_overlap=1))


# the unpreconditioned solve runs on a constant coefficient: on the
# high-contrast one its iteration count hangs on roundoff in either package
@pytest.mark.parametrize("gen_args,ksp_type,pc_type,lvl1,lvl2,dls1", [
    (GEN_ARGS, "cg", "geneo", "ASM", "E1", "inverse_pallas"),
    (GEN_ARGS, "cg", "geneo", "SRAS", "H1", "cholesky"),
    (GEN_ARGS, "gmres", "geneo", "SORAS", "2", "cholesky"),
    ("--size 12 --dim 2", "cg", "none", "ASM", "0", "cholesky"),
])
def test_solve_mesh_matches_jax(gen_args, ksp_type, pc_type, lvl1, lvl2,
                                dls1):
    ref = jax_solve_mesh(
        jax_laplacian.get_input(gen_args), n_dom=4, pc_type=pc_type,
        **dict(zip(("geneo", "ksp", "driver"), _opts(
            JaxGenEOOptions, JaxKSPOptions, JaxDriverOptions, lvl1, lvl2,
            ksp_type, dls1))))
    got = solve_mesh(
        laplacian.get_input(gen_args), torch.device("cpu"), n_dom=4,
        pc_type=pc_type, **dict(zip(("geneo", "ksp", "driver"), _opts(
            GenEOOptions, KSPOptions, DriverOptions, lvl1, lvl2, ksp_type,
            dls1))))
    assert (got.its, got.result.reason) == (ref.its, int(ref.result.reason))
    assert got.converged
    assert np.linalg.norm(got.x - ref.x) <= 1e-6 * np.linalg.norm(ref.x)
    hist = got.result.history.numpy()
    np.testing.assert_array_equal(np.isnan(hist),
                                  np.isnan(np.asarray(ref.result.history)))


def test_cli_info_lines_match_jax():
    args = ["--inpLibA", "laplacian", "--inpLibArg",
            "--size#12#--dim#2#--kappa#1000.#minmax", "--nbPart", "4",
            "--addOverlap", "1", "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
            "-dls1_type", "inverse_pallas", "-ksp_type", "cg",
            "-ksp_rtol", "1e-8", "--verbose", "1"]
    ref, got = io.StringIO(), io.StringIO()
    assert jax_cli.run(args, out=ref) == 0
    assert cli.run(args + ["--device", "cpu"], out=got) == 0

    def info(log):
        return [ln for ln in log.splitlines()
                if ln.startswith(("INFO", "WRNG"))]

    assert info(got.getvalue()) == info(ref.getvalue())
    assert len(info(got.getvalue())) == 5
    assert "The solution X is:" in got.getvalue()


@pytest.mark.parametrize("extra,item", [
    (["-ksp_type", "cg", "--structured", "2,2,1", "--inpLibA",
      "elasticity"], "item 18"),
    (["--nbDevices", "2"], "item 19"),
    (["--debug", "log"], "item 11"),
    (["-geneo_dbg", "log,1"], "item 11"),
    (["-geneo_chk", "1"], "item 11"),
])
def test_cli_rejects_unported_options(extra, item, capsys, tmp_path,
                                      monkeypatch):
    """Options of code not ported yet would exit with code 1 and name
    their ROADMAP item; those of items 11 (debug dumps, checks), 18 (the
    elastic backend) and 19 (multi-rank runs, here 2 gloo ranks), all
    ported since, run and exit 0 with no such message."""
    monkeypatch.chdir(tmp_path)
    args = ["--inpLibA", "laplacian", "--inpLibArg", "--size#4#--dim#2",
            "--device", "cpu", "-pc_type", "geneo"] + extra
    rc = cli.run(args, out=io.StringIO())
    err = capsys.readouterr().err
    assert rc == 0 and "not ported" not in err


@pytest.mark.parametrize("extra,pc_line", [
    (["-els2_type", "lobpcg", "-geneo_lvl", "ASM,E1"],
     "L2 lobpcg cholesky"),
    (["-els2_type", "krylovschur", "-geneo_lvl", "SORAS,2", "-geneo_cut",
      "2"], "L2 lobpcg cholesky"),
    (["-pc_type", "bjacobi"], "INFO: bjacobi pc"),
    (["-pc_type", "mg", "-pc_mg_cycle_type", "w", "-pc_mg_smoothdown", "2",
      "-pc_mg_smoothup", "2"], "INFO: mg pc"),
])
def test_cli_runs_comparison_pcs_and_lobpcg(extra, pc_line):
    """The options that exited 1 before their modules were ported:
    -pc_type bjacobi|mg and -els2_type lobpcg (krylovschur maps to it)
    on the generic path."""
    args = ["--inpLibA", "laplacian", "--inpLibArg", "--size#8#--dim#2",
            "--nbPart", "2", "--device", "cpu", "-ksp_type", "cg",
            "-pc_type", "geneo"] + extra
    buf = io.StringIO()
    assert cli.run(args, out=buf) == 0
    assert pc_line in buf.getvalue()
    assert "INFO: solve - converged" in buf.getvalue()


def test_cli_default_pc_is_bjacobi():
    """PETSc's parallel default: no -pc_type runs block Jacobi."""
    buf = io.StringIO()
    assert cli.run(["--inpLibA", "laplacian", "--inpLibArg",
                    "--size#8#--dim#2", "--device", "cpu"], out=buf) == 0
    assert "INFO: bjacobi pc" in buf.getvalue()
    assert "INFO: solve - converged" in buf.getvalue()


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--inpLibA", "laplacian", "--inpLibArg", "--size#4#--dim#2",
                 "-pc_type", "geneo"], out=io.StringIO())


def test_module_entry_point_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "geneo4petsc_tpu_torch", "--inpLibA",
         "laplacian", "--inpLibArg", "--size#6#--dim#2", "--nbPart", "2",
         "-pc_type", "geneo", "-geneo_lvl", "ASM,1", "-ksp_type", "cg",
         "--device", "cpu", "--timing"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "INFO: solve - converged" in proc.stdout
    assert "TIME: total time" in proc.stdout
