"""End-to-end multi-rank CLI runs of the port (``--nbDevices``) on the
CPU, with tests/test_cli_multidevice.py's configurations.

The reference's primary interface is ``mpirun -n N geneo4PETSc ...``
(src/geneo4PETSc.cpp:1569-1633); the port's CLI launches N local gloo
ranks itself (parallel/multiproc.py).  Here each rank count is launched
once for the file, and its ranks run every case of that count through
the CLI as members of the group.  Contracts:

* generic path (owner-block vectors, parallel/dist.py): the same
  iteration count as the single-process CLI, float64;
* structured path (z-slab ranks), float32 inner CG in float64
  refinement, as the CLI runs it: within JAX's bands (0 / 0 / 1) of the
  port's single-process count (one thread for torch and BLAS, as each
  rank has), true residual <= 1e-8; except ASM,E1 on 8 ranks, held to 2.
  In float32 the first outer pass ends at the float32 floor, its true
  residual lands anywhere in a factor-2 range set by the rounding of the
  correction (1.0e-6 to 1.9e-6 over 1-8 ranks for ASM,E1), and that
  residual sets the second pass's tolerance: 40 inner on 1, 2 and 4
  ranks, 38 on 8.  The JAX package's own float32 counts move the same way
  across its device counts (RAS,1: 37, 38, 36, 43 on 1, 2, 4, 8).  With
  float64 inner iterations the counts agree on every rank count in both
  packages: tests/test_torch_rank_solves.py holds that exactly (ROADMAP
  Queue 3, tests/_torch_roundoff_witness.py ranks);
* elastic: within 2 of the single-process count, residual <= 1e-8;
* a misaligned mesh exits 1 before any rank starts; ``--nbDevices`` is
  ignored with a WRNG for -pc_type bjacobi;
* both ranks of one run hold the same solution, bit for bit.
"""
import functools
import io
import re

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.parallel import multiproc, probes
from geneo4petsc_tpu_torch.structured import grid as tgrid

from _threads import torch_threads
from _time_limit import wait_s

pytestmark = pytest.mark.timeout_s(600)

GENERIC_CONFIGS = [
    ("-pc_type geneo -geneo_lvl ASM,1", 4),
    ("-pc_type geneo -geneo_lvl RAS,H1", 8),
    ("-pc_type geneo -geneo_lvl SORAS,E2", 4),
]
STRUCTURED_CONFIGS = [
    ("laplacian", "ASM,E1", 8, 2),
    ("laplacian", "RAS,1", 4, 0),
    ("heat", "SORAS,2", 2, 1),
]


def _generic_args(pc):
    return ["--inpLibA", "laplacian",
            "--inpLibArg", "--size 12#--dim 2#--kappa 100. minmax",
            "--nbPart", "6", "--addOverlap", "1",
            "-ksp_rtol", "1e-8"] + pc.split()


def _structured_args(wl, lvl):
    return ["--inpLibA", wl,
            "--inpLibArg", "--size 16#--dim 3#--kappa 100. minmax",
            "--structured", "2,2,2", "--addOverlap", "1",
            "-pc_type", "geneo", "-geneo_lvl", lvl,
            "-ksp_type", "cg", "-ksp_rtol", "1e-8"]


ELASTIC_ARGS = ["--inpLibA", "elasticity",
                "--inpLibArg", "--size 8#--kappa 100. minmax#--spring 100.",
                "--structured", "2,2,2", "--addOverlap", "1",
                "-pc_type", "geneo", "-geneo_lvl", "RAS,1",
                "-geneo_cut", "8", "-ksp_type", "cg", "-ksp_rtol", "1e-8"]


def _cli_call(args, n):
    return ("cli", (args + ["--device", "cpu", "--nbDevices", str(n)],), {})


def _launch_plan():
    """Every multi-rank case of the file: {ranks: [(key, probe call)]}."""
    plan = {}
    for pc, n in GENERIC_CONFIGS:
        plan.setdefault(n, []).append((("generic", pc),
                                       _cli_call(_generic_args(pc), n)))
    for wl, lvl, n, _band in STRUCTURED_CONFIGS:
        plan.setdefault(n, []).append(((wl, lvl), _cli_call(
            _structured_args(wl, lvl), n)))
    plan[8].append((("elasticity",), _cli_call(ELASTIC_ARGS, 8)))
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "RAS", "1"
    grid = tgrid.laplacian_grid(8, dim=3, kappa_max=100.0, interp="minmax")
    plan[2].append((("solutions",), ("solutions", (
        "structured", (grid, (2, 2, 2), 1), dict(
            geneo=opts, ksp=KSPOptions(type="cg"), device="cpu",
            n_devices=2)), {})))
    return plan


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, request):
    """One launch per rank count; {(n, key): rank 0's probe result}."""
    got = {}
    plan = _launch_plan()
    wait = wait_s(request.node, waits=len(plan))
    for n, cases in sorted(plan.items()):
        store = tmp_path_factory.mktemp("ranks") / "store"
        out = multiproc.run_ranks(
            probes.batch, n, args=([call for _key, call in cases],),
            init_method=f"file://{store}", timeout=wait)
        got.update({(n, key): r for (key, _call), r in zip(cases, out)})
    return got


def _run(args):
    buf = io.StringIO()
    # the ranks' own thread counts
    with torch_threads(1), threadpool_limits(1):
        rc = cli.run(args + ["--device", "cpu"], out=buf)
    return rc, buf.getvalue()


@functools.lru_cache(maxsize=None)
def _single(args: tuple):
    """The single-process CLI run of ``args``, once per process."""
    return _run(list(args))


def _iters(out):
    m = re.search(r"(\d+) iteration\(s\)", out)
    assert m, out
    return int(m.group(1))


def _true_res(out):
    m = re.search(r"\|\| AX - B \|\| / \|\| B \|\| ([0-9.eE+-]+)", out)
    assert m, out
    return float(m.group(1))


@pytest.mark.parametrize("pc,ndev", GENERIC_CONFIGS)
def test_generic_cli_multidevice_iteration_parity(ranks, pc, ndev):
    rc1, out1 = _single(tuple(_generic_args(pc)))
    rcn, outn = ranks[(ndev, ("generic", pc))]
    assert rc1 == 0 and rcn == 0
    assert "converged" in out1 and "converged" in outn
    assert _iters(outn) == _iters(out1), f"\n{out1}\n{outn}"
    assert f"nb devices {ndev}" in outn


def test_generic_cli_nbdevices_ignored_for_non_geneo():
    rc, out = _run(["--inpLibA", "laplacian", "--inpLibArg",
                    "--size 10#--dim 2", "--nbPart", "4", "-pc_type",
                    "bjacobi", "--nbDevices", "4", "-ksp_rtol", "1e-8"])
    assert rc == 0
    assert "WRNG: --nbDevices ignored" in out
    assert "converged" in out


@pytest.mark.parametrize("wl,lvl,ndev,band", STRUCTURED_CONFIGS)
def test_structured_cli_multidevice_iteration_parity(ranks, wl, lvl, ndev,
                                                     band):
    rc1, out1 = _single(tuple(_structured_args(wl, lvl)))
    rcn, outn = ranks[(ndev, (wl, lvl))]
    assert rc1 == 0 and rcn == 0
    assert "converged" in out1 and "converged" in outn
    assert abs(_iters(outn) - _iters(out1)) <= band, f"\n{out1}\n{outn}"
    assert _true_res(outn) <= 1e-8
    assert f"nb devices {ndev}" in outn


def test_structured_cli_multidevice_rejects_misaligned_mesh(capsys):
    rc, _out = _run(["--inpLibA", "laplacian", "--inpLibArg",
                     "--size 15#--dim 3", "--structured", "1,1,3",
                     "-pc_type", "geneo", "-geneo_lvl", "ASM,1",
                     "-ksp_type", "cg", "--nbDevices", "8"])
    assert rc == 1
    assert "must divide the mesh size 8" in capsys.readouterr().err


def test_elastic_cli_multidevice_converges(ranks):
    rc1, out1 = _single(tuple(ELASTIC_ARGS))
    rcn, outn = ranks[(8, ("elasticity",))]
    assert rc1 == 0 and rcn == 0
    assert "converged" in out1 and "converged" in outn
    assert abs(_iters(outn) - _iters(out1)) <= 2, f"\n{out1}\n{outn}"
    assert _true_res(outn) <= 1e-8


def test_both_ranks_hold_the_same_result(ranks):
    (its0, x0), (its1, x1) = ranks[(2, ("solutions",))]
    assert its0 == its1
    np.testing.assert_array_equal(x0, x1)
