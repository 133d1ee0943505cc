"""The coarse-replication warning of the PyTorch port against the JAX
package's, on the CPU.

``coarse_replication_wall`` reads the port's own measurement
(geneo4petsc_tpu_torch/perf/coarse_scaling.json) and falls back to 16384
without it.  With both packages' walls set below a run's coarse dimension
(JAX's module global ``_REPLICATION_WALL``, the port's function), the
same generic CLI golden case and the same structured case print one
``WRNG: dim_e = ... exceeds`` line to stderr in both, with the same
dim_e; the port's stdout, the golden-diffed protocol, is byte for byte
the one it prints with the wall above dim_e.  The elastic backend shares
the structured ``finalize_coarse`` and warns too."""

import io
import json
import re

import pytest
import torch

from geneo4petsc_tpu import cli as jax_cli
from geneo4petsc_tpu.precond import geneo as jax_geneo
from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.precond import geneo as pgeneo
from geneo4petsc_tpu_torch.structured.elastic import (elastic_grid,
                                                      solve_elastic)

_RE_WRNG = re.compile(r"^WRNG: dim_e = (\d+) exceeds the measured "
                      r"replicated-coarse-solve wall \((\d+)\)", re.M)
_RE_DIME = re.compile(r"real dimE (\d+)")

# (JAX CLI arguments; the port's CLI adds --device cpu)
CASES = {
    # tst/golden/iteration_counts.json
    # laplacian-np=2-pc=geneoASME1-metis=dual (tst/iters.py's arguments)
    "generic": ["--inpLibA", "laplacian", "--inpLibArg",
                "--size#10#--weakScaling#1#--dim#2", "--nbPart", "2",
                "--metisDual", "-ksp_rtol", "1.e-05", "-ksp_atol", "1.e-05",
                "-ksp_max_it", "1000", "-ksp_gmres_restart", "1000",
                "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
                "-geneo_tau", "0.1", "-geneo_gamma", "8."],
    "structured": ["--structured", "2,2,2", "--inpLibA", "laplacian",
                   "--inpLibArg", "--size#12#--dim#3#--kappa#100.#minmax",
                   "--addOverlap", "1", "-pc_type", "geneo", "-geneo_lvl",
                   "ASM,E1", "-geneo_cut", "2", "-ksp_type", "cg",
                   "-ksp_rtol", "1e-8"],
}


def _run(run, args, capsys) -> tuple[str, str]:
    """(stdout protocol, stderr) of one CLI run."""
    capsys.readouterr()
    buf = io.StringIO()
    assert run(args, out=buf) == 0
    return buf.getvalue(), capsys.readouterr().err


def _port_wall(monkeypatch, wall: int) -> None:
    monkeypatch.setattr(pgeneo, "coarse_replication_wall", lambda: wall)


def test_wall_read_from_the_port_file(monkeypatch, tmp_path):
    with open(pgeneo.COARSE_SCALING) as f:
        rec = json.load(f)
    assert pgeneo.coarse_replication_wall() == rec["replication_wall_dim_e"]
    assert "NVIDIA" in rec["card"] and rec["power_limit"]
    path = tmp_path / "coarse_scaling.json"
    path.write_text(json.dumps({"replication_wall_dim_e": 123}))
    monkeypatch.setattr(pgeneo, "COARSE_SCALING", str(path))
    assert pgeneo.coarse_replication_wall() == 123
    monkeypatch.setattr(pgeneo, "COARSE_SCALING", str(tmp_path / "none"))
    assert pgeneo.coarse_replication_wall() == 16384


@pytest.mark.parametrize("case", CASES)
def test_wrng_in_both_packages(case, monkeypatch, capsys):
    monkeypatch.setattr(jax_geneo, "_REPLICATION_WALL", 1)
    _port_wall(monkeypatch, 1)
    jax_out, jax_err = _run(jax_cli.run, CASES[case], capsys)
    out, err = _run(cli.run, CASES[case] + ["--device", "cpu"], capsys)
    dim_e = int(_RE_DIME.search(out).group(1))
    assert dim_e == int(_RE_DIME.search(jax_out).group(1)) > 1
    assert _RE_WRNG.findall(err) == [(str(dim_e), "1")]
    assert _RE_WRNG.findall(jax_err) == [(str(dim_e), "1")]
    assert "WRNG" not in out
    # the text is JAX's but for the measurement file it names
    line = next(ln for ln in err.splitlines() if ln.startswith("WRNG"))
    jax_line = next(ln for ln in jax_err.splitlines()
                    if ln.startswith("WRNG"))
    assert line.replace("geneo4petsc_tpu_torch/perf/coarse_scaling.json",
                        "tst/golden/coarse_scaling.json") == jax_line


@pytest.mark.parametrize("case", CASES)
def test_port_stdout_unchanged_by_the_warning(case, monkeypatch, capsys):
    args = CASES[case] + ["--device", "cpu"]
    _port_wall(monkeypatch, 1)
    low, low_err = _run(cli.run, args, capsys)
    _port_wall(monkeypatch, 10 ** 9)
    high, high_err = _run(cli.run, args, capsys)
    assert _RE_WRNG.search(low_err) and not _RE_WRNG.search(high_err)
    # the TIME lines are off without --timing: the protocol is
    # deterministic
    assert low == high


def test_elastic_route_warns(monkeypatch, capsys):
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "1"
    opts.dls1.rtol, opts.dls1.max_it = 1e-11, 500
    _port_wall(monkeypatch, 1)
    capsys.readouterr()
    out = solve_elastic(elastic_grid(6, kappa_max=1e3, interp="minmax"),
                        (2, 2, 1), 1, opts, tol=1e-8, dtype=torch.float64,
                        device="cpu")
    dim_e = int(out.stats.real_dim_e.sum())
    assert out.converged and dim_e > 1
    assert _RE_WRNG.findall(capsys.readouterr().err) == [(str(dim_e), "1")]
