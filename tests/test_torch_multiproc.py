"""The mpirun-style launch of the port (parallel/multiproc.init_from_env):
two OS processes started by hand with GENEO_COORDINATOR /
GENEO_NUM_PROCS / GENEO_PROC_ID (a ``file://`` rendezvous under
tmp_path) join one gloo group and run the real structured solve of
tests/test_multiprocess.py (laplacian 24^3, 2x2x2 boxes, overlap 2,
ASM,E1, cut 2, CG to 1e-8) through the CLI with ``--nbDevices auto``.

Contract, exact: the same inner and outer iterations, coarse dimension
and residual as the CLI's own one-command launch of 2 ranks
(``--nbDevices 2``), whose ranks run with the same one thread each; only
process 0 prints the INFO lines, and it reports the group on stderr."""

import os
import re
import subprocess
import sys
import time

import pytest

from _time_limit import wait_s

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--inpLibA", "laplacian", "--inpLibArg",
        "--size#24#--dim#3#--kappa#10000.#minmax", "--structured", "2,2,2",
        "--addOverlap", "2", "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
        "-geneo_cut", "2", "-ksp_type", "cg", "-ksp_rtol", "1e-8",
        "--device", "cpu"]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("GENEO_COORDINATOR", "GENEO_NUM_PROCS", "GENEO_PROC_ID"):
        env.pop(k, None)
    env.update(extra)
    return env


def _solve_line(out):
    m = re.search(r"INFO: solve - converged \(refined, (\d+) outer\), "
                  r"(\d+) iteration\(s\), \|\| AX - B \|\| / \|\| B \|\| "
                  r"(\S+)", out)
    assert m, out
    dim_e = re.search(r"real dimE (\d+)", out)
    return int(m.group(1)), int(m.group(2)), float(m.group(3)), \
        int(dim_e.group(1))


@pytest.fixture(scope="module")
def by_hand(tmp_path_factory, request):
    store = tmp_path_factory.mktemp("rendezvous") / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "geneo4petsc_tpu_torch", *ARGS,
         "--nbDevices", "auto"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(GENEO_COORDINATOR=f"file://{store}", GENEO_NUM_PROCS="2",
                 GENEO_PROC_ID=str(pid))) for pid in range(2)]
    outs = []
    # the two ranks run at once: one wait for both
    deadline = time.monotonic() + wait_s(request.node)
    try:
        for p in procs:
            outs.append(p.communicate(timeout=deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    return outs


def test_env_rendezvous_matches_the_one_command_launch(by_hand, request):
    one = subprocess.run(
        [sys.executable, "-m", "geneo4petsc_tpu_torch", *ARGS,
         "--nbDevices", "2"], cwd=ROOT, capture_output=True, text=True,
        env=_env(), timeout=wait_s(request.node))
    assert one.returncode == 0, one.stderr
    got = _solve_line(by_hand[0][0])
    assert got == _solve_line(one.stdout)
    assert got[2] <= 1e-8
    assert "nb devices 2" in by_hand[0][0]


def test_only_process_0_prints(by_hand):
    (out0, err0), (out1, err1) = by_hand
    assert "INFO: distributed: process 0/2" in err0
    assert out1 == "" and "INFO:" not in err1
