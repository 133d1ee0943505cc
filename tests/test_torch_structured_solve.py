"""End-to-end structured solves of the PyTorch port against the JAX
package (``solve_structured``, the ``--structured`` CLI), on the CPU.

Each JAX solve runs once per module (fixture).  Tolerances: equal
per-domain coarse dimensions and Nicolaides counts; equal outer
refinement passes; inner iterations equal within 1 in float64 and 2 in
float32 (the inner Krylov loop stops near the float32 roundoff floor,
where the two packages' summation orders part); solutions within 1e-8
relative (float64) and 1e-7 (float32) of each other."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu import cli as jax_cli
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.structured import grid as jgrid
from geneo4petsc_tpu.structured.solve import solve_structured as jax_solve
from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.structured import geneo as tgeneo
from geneo4petsc_tpu_torch.structured import grid as tgrid
from geneo4petsc_tpu_torch.structured.solve import solve_structured

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """Compile the JAX reference with most XLA optimizations off: the
    same programs, compiled in about half the time.  Compiled programs
    are dropped before (every reference of this file is compiled the
    same way, whatever ran earlier in the process) and after (later
    tests compile their own with full optimization)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
    jax.clear_caches()


def jax_start(d, n, k, dtype):
    """The JAX package's LOBPCG start block (structured/geneo.py)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, n, k),
                                      jdt))


# name: (grid kind, size, dim, kappa_max, dom_grid, overlap, lvl, optim,
#        dtype bits, els2 lobpcg, device_refine); the 3-D E1 case runs the
#        device refinement route in both packages, the others the host
#        route (each package's rule on the CPU)
RUNS = {
    f"{s}-{d}d-{lvl}": ("laplacian", s, d, 1e3, g, L, lvl, 0.0, 64, False,
                        d == 3 and lvl == "ASM,E1")
    for s, d, g, L in [(8, 2, (2, 2, 1), 1), (12, 2, (3, 2, 1), 2),
                       (8, 3, (2, 2, 2), 2)]
    for lvl in ("ASM,1", "ASM,E1")
}
RUNS.update({
    "soras2": ("laplacian", 16, 2, 1e3, (2, 2, 1), 2, "SORAS,2", 1.0, 64,
               False, False),
    "heat": ("heat", 12, 2, 1e3, (3, 2, 1), 2, "ASM,E1", 0.0, 64, False,
             False),
    "lobpcg-f32": ("laplacian", 16, 2, 1e4, (2, 2, 1), 2, "ASM,E1", 0.0, 32,
                   True, False),
})


def _run(pkg, spec):
    kind, size, dim, kmax, dg, overlap, lvl, optim, bits, lobpcg, dev = spec
    grid_mod, opts, ksp = ((jgrid, JaxGenEOOptions(), JaxKSPOptions)
                           if pkg == "jax" else
                           (tgrid, GenEOOptions(), KSPOptions))
    grid = getattr(grid_mod, f"{kind}_grid")(size, dim=dim, kappa_max=kmax,
                                             interp="minmax")
    opts.lvl1, opts.lvl2 = lvl.split(",")
    opts.optim = optim
    if lobpcg:      # the 10M-DOF case's eigensolver settings
        opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 50, 2
    kw = dict(geneo=opts, ksp=ksp(type="cg"), tol=1e-8, device_refine=dev)
    if pkg == "jax":
        return jax_solve(grid, dg, overlap,
                         dtype=jnp.float64 if bits == 64 else jnp.float32,
                         **kw)
    return solve_structured(
        grid, dg, overlap, dtype=torch.float64 if bits == 64 else
        torch.float32, device="cpu", lobpcg_start=jax_start, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run("jax", spec) for name, spec in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_solve_structured_matches_jax(name, jax_runs):
    want, got = jax_runs[name], _run("torch", RUNS[name])
    f32 = RUNS[name][8] == 32
    assert got.converged and want.converged
    assert got.true_res <= 1e-8
    np.testing.assert_array_equal(got.stats.real_dim_e,
                                  want.stats.real_dim_e)
    np.testing.assert_array_equal(got.stats.nicolaides,
                                  want.stats.nicolaides)
    assert got.refined.outer_its == want.refined.outer_its
    assert abs(got.its - want.its) <= (2 if f32 else 1)
    x_ref = np.asarray(want.x, np.float64)
    assert (np.linalg.norm(got.x - x_ref) / np.linalg.norm(x_ref)
            <= (1e-7 if f32 else 1e-8))
    if RUNS[name][6].endswith("2"):
        np.testing.assert_allclose(got.stats.tau_loc, want.stats.tau_loc,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.stats.gamma_loc,
                                   want.stats.gamma_loc, rtol=1e-12)


def test_structured_cli_info_lines_match_jax(monkeypatch, jax_runs):
    # the "lobpcg-f32" run (the bench's settings) through both CLIs, from
    # JAX's start block: the JAX programs compiled for that run serve again
    args = ["--structured", "2,2,1", "--inpLibA", "laplacian",
            "--inpLibArg", "--size#16#--dim#2#--kappa#10000.#minmax",
            "--addOverlap", "2", "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
            "-els2_type", "lobpcg", "-els2_eps_max_it", "50", "-geneo_cut",
            "2", "-ksp_type", "cg", "-ksp_rtol", "1e-8", "--timing"]
    monkeypatch.setattr(tgeneo, "default_start", jax_start)
    ref, got = io.StringIO(), io.StringIO()
    assert jax_cli.run(args, out=ref) == 0
    assert cli.run(args + ["--device", "cpu"], out=got) == 0

    def lines(log, prefix):
        return [ln for ln in log.splitlines() if ln.startswith(prefix)]

    assert lines(got.getvalue(), "INFO") == lines(ref.getvalue(), "INFO")
    assert len(lines(got.getvalue(), "INFO")) == 5
    # the same TIME lines, numbers excepted
    strip = str.maketrans("", "", "0123456789.")
    assert ([ln.translate(strip) for ln in lines(got.getvalue(), ("TIME",
                                                                   "  "))]
            == [ln.translate(strip) for ln in lines(ref.getvalue(),
                                                    ("TIME", "  "))])


def test_structured_cli_runs_heat_and_lobpcg_on_cpu():
    out = io.StringIO()
    assert cli.run(["--structured", "3,2,1", "--inpLibA", "heat",
                    "--inpLibArg", "--size#12#--dim#2#--kappa#100.#minmax",
                    "--addOverlap", "2", "-pc_type", "geneo", "-geneo_lvl",
                    "ASM,E1", "-els2_type", "lobpcg", "-geneo_cut", "2",
                    "-ksp_type", "cg", "-ksp_rtol", "1e-8", "--device",
                    "cpu"], out=out) == 0
    log = out.getvalue()
    assert "L1 block-tridiag, tau 0.10, L2 lobpcg shift-invert" in log
    assert "INFO: solve - converged (refined" in log


@pytest.mark.parametrize("extra,item", [
    (["-ksp_type", "cg", "--inpLibA", "elasticity"], "item 18"),
    (["--nbDevices", "2"], "item 19"),
])
def test_structured_cli_refuses_unported(extra, item, capsys):
    """--inpLibA elasticity (item 18) runs the elastic backend to
    convergence; --nbDevices (item 19, multi-rank runs), ported since,
    reaches the structured path's own check: this grid's nz = 1 does not
    split over 2 ranks, refused with code 1 and the JAX package's text,
    before any rank starts."""
    args = ["--structured", "2,2,1", "--inpLibA", "laplacian", "--inpLibArg",
            "--size#4#--dim#2", "--device", "cpu", "-pc_type", "geneo"]
    out = io.StringIO()
    rc = cli.run(args + extra, out=out)
    err = capsys.readouterr().err
    assert "not ported" not in err
    if item == "item 19":
        assert rc == 1 and "must divide the mesh size 2" in err
    else:
        assert rc == 0
        assert "INFO: nb DOFs 192," in out.getvalue()
        assert "INFO: solve - converged (refined" in out.getvalue()


def test_structured_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import pkgutil, importlib\n"
            "import geneo4petsc_tpu_torch.structured as s\n"
            "names = [m.name for m in pkgutil.iter_modules(s.__path__)]\n"
            "for n in names:\n"
            "    importlib.import_module('geneo4petsc_tpu_torch.structured.'"
            " + n)\n"
            "import geneo4petsc_tpu_torch.ops.lobpcg\n"
            "import geneo4petsc_tpu_torch.krylov.refine\n"
            "import geneo4petsc_tpu_torch.perf.lobpcg_start\n"
            "import geneo4petsc_tpu_torch.cli\n"
            "assert not any(m.startswith('geneo4petsc_tpu.') or "
            "m == 'geneo4petsc_tpu' for m in sys.modules)\n"
            "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    # the structured path's modules, elastic.py (the Q1 elastic backend),
    # blockmode.py and sharded.py (the block and rank-split layouts)
    assert int(proc.stdout.strip()) == 12
