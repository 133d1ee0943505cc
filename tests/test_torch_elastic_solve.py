"""The elastic backend's GenEO setup and solves of the PyTorch port against
the JAX package (float64, on the CPU): the dense (identity-probed,
exact-eigh) route and the ``--structured --inpLibA elasticity`` CLI.

On the dense route both packages solve the same pencils exactly, so the
pencil windows (raw coarse dimensions), the adaptive tauLoc and gammaLoc
(to 1e-12), the number of coarse columns the prune keeps and the
flexible-CG iteration counts are equal; the CLI prints the same INFO
lines."""

import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geneo4petsc_tpu import cli as jax_cli
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.structured import elastic as jel
from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.config import GenEOOptions
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.structured import elastic as el

from _threads import torch_threads

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: run torch on one intra-op
    thread, so that parallel test workers do not oversubscribe the
    cores (threads spinning on tiny ops cost more than they save)."""
    with torch_threads(1):
        yield


def _opts(cls, lvl):
    o = cls(optim=1.0)
    o.lvl1, o.lvl2 = lvl.split(",")
    o.dls1.rtol = 1e-11             # drive the inexact PCG to near-exact
    o.dls1.max_it = 500
    return o


@pytest.mark.parametrize("lvl", ["ASM,1", "SORAS,2", "SORAS,E2",
                                 "SORAS,H2"])
def test_dense_route_matches_jax(lvl):
    """setup_elastic at size 6, 2x2x1 boxes, overlap 1 (the JAX
    package's tests/test_elastic_structured.py cases), then flexible CG
    to 1e-8 in each package."""
    g = el.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    jg = jel.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    x_true, b = g.manufactured_rhs()
    jo = _opts(JaxGenEOOptions, lvl)
    jpc, jst = jel.setup_elastic(jg, (2, 2, 1), 1, jo,
                                 b=jnp.asarray(b), dtype=jnp.float64)
    jr = jax_cg(jpc.matvec, jnp.asarray(b), jpc.apply,
                x0=jpc.x0 if jo.eff_hybrid else None, rtol=1e-8,
                flexible=True)
    o = _opts(GenEOOptions, lvl)
    pc, st = el.setup_elastic(g, (2, 2, 1), 1, o, b=torch.tensor(b),
                              dtype=torch.float64, device=CPU)
    r = cg_solve(pc.matvec, torch.tensor(b), pc.apply,
                 x0=pc.x0 if o.eff_hybrid else None, rtol=1e-8,
                 flexible=True)
    np.testing.assert_array_equal(st.raw_dim_e, jst.raw_dim_e)
    np.testing.assert_array_equal(st.nicolaides, jst.nicolaides)
    # GenEO-2's windows hold exactly dependent columns (raw 4 x 192 here):
    # the pivoted-Cholesky prune removes the same number in both
    # packages, but which column of a dependent set goes is decided by
    # rounding (ROADMAP Queue 3), so the per-domain split may differ
    assert st.e_pruned == jst.e_pruned
    assert int(st.real_dim_e.sum()) == int(jst.real_dim_e.sum())
    if not jst.e_pruned:
        np.testing.assert_array_equal(st.real_dim_e, jst.real_dim_e)
    if lvl.endswith("2"):
        np.testing.assert_allclose(st.tau_loc, jst.tau_loc, rtol=1e-12)
        np.testing.assert_allclose(st.gamma_loc, jst.gamma_loc, rtol=1e-12)
    assert r.reason > 0 and int(jr.reason) > 0
    assert r.its == int(jr.its)
    x = r.x.numpy()
    assert np.linalg.norm(g.matvec(x) - b) / np.linalg.norm(b) < 1e-7
    np.testing.assert_allclose(x, np.asarray(jr.x), rtol=0,
                               atol=1e-6 * np.abs(x_true).max())


ELASTIC_ARGS = ["--structured", "2,2,1", "--inpLibA", "elasticity",
                "--inpLibArg", "--size#6#--kappa#1000.#minmax",
                "--addOverlap", "1", "-pc_type", "geneo", "-geneo_lvl",
                "ASM,E1", "-ksp_type", "cg", "-ksp_rtol", "1e-8"]


def test_elastic_cli_info_lines_match_jax(tmp_path, monkeypatch):
    """The elastic CLI (solve_elastic on the host route, float64 on the
    CPU) prints the JAX CLI's INFO lines: the DOF, element and nnz
    counts, the PC line, the coarse dimensions and the refined solve's
    outer and inner iterations and true residual."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GENEO_CHECKPOINT_DIR", raising=False)
    want, got = io.StringIO(), io.StringIO()
    assert jax_cli.run(ELASTIC_ARGS, out=want) == 0
    assert cli.run(ELASTIC_ARGS + ["--device", "cpu"], out=got) == 0

    def info(buf):
        return [ln for ln in buf.getvalue().splitlines()
                if ln.startswith(("INFO", "WRNG"))]

    assert info(got) == info(want)
    assert "converged (refined" in got.getvalue()
    assert not os.listdir(tmp_path)


def test_elastic_cli_refuses_gmres_and_devices():
    """GMRES is refused (the level-1 solves are inexact); --nbDevices,
    ported since, runs the elastic backend on 2 ranks, and a rank count
    the mesh cannot split is refused before any rank starts."""
    buf = io.StringIO()
    assert cli.run(ELASTIC_ARGS[:-4] + ["-ksp_type", "gmres", "--device",
                                        "cpu"], out=buf) == 1
    buf = io.StringIO()
    assert cli.run(ELASTIC_ARGS + ["--nbDevices", "2", "--device", "cpu"],
                   out=buf) == 0
    assert "nb devices 2" in buf.getvalue()
    assert "INFO: solve - converged (refined" in buf.getvalue()
    g = el.elastic_grid(4)
    with pytest.raises(ValueError, match="must divide the mesh size 3"):
        el.solve_elastic(g, (2, 1, 1), 1, device=CPU, n_devices=3)
