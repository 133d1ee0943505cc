"""Setup checkpoints of the PyTorch port (utils/checkpoint.py): a saved
and loaded preconditioner applies with the same bits and solves with the
same iterations; a warm structured or elastic setup from
``checkpoint_dir`` gives the cold run's iterations and solution, as the
JAX package's GENEO_CHECKPOINT_DIR does (float64, on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg
from geneo4petsc_tpu.models import laplacian as jax_laplacian
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_decompose
from geneo4petsc_tpu.precond.geneo import setup_geneo as jax_setup
from geneo4petsc_tpu.structured.grid import laplacian_grid as jax_grid
from geneo4petsc_tpu.structured.solve import \
    solve_structured as jax_solve_structured
from geneo4petsc_tpu.utils.checkpoint import load_pc as jax_load_pc
from geneo4petsc_tpu.utils.checkpoint import save_pc as jax_save_pc
from geneo4petsc_tpu_torch.assembly.assemble import assemble
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.krylov.cg import cg_solve
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.partition.decompose import partition_and_decompose
from geneo4petsc_tpu_torch.precond.geneo import setup_geneo
from geneo4petsc_tpu_torch.structured import elastic as el
from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
from geneo4petsc_tpu_torch.structured.solve import solve_structured
from geneo4petsc_tpu_torch.utils import checkpoint as ck

CPU = torch.device("cpu")


def test_generic_roundtrip_matches_jax(tmp_path):
    """SORAS,H2 on laplacian 12x12, 4 domains: the loaded preconditioner
    applies with the same bits and CG takes the same iterations, as the
    JAX package's own round trip (tests/test_checkpoint.py)."""
    args = "--size 12 --dim 2 --kappa 100. minmax"
    mesh = laplacian.get_input(args)
    d = partition_and_decompose(mesh, 4, add_overlap=1)
    ap = assemble(mesh, d, CPU)
    g = GenEOOptions()
    g.lvl1, g.lvl2 = "SORAS", "H2"
    pc, _ = setup_geneo(ap.batch, g, decomp=d)
    path = tmp_path / f"pc-{ck.config_fingerprint(lvl='SORAS,H2', n=4)}.pt"
    ck.save_pc(str(path), pc)
    pc2 = ck.load_pc(str(path), device=CPU)
    assert (pc2.lvl1, pc2.dim_e, pc2.l1_kind) == (pc.lvl1, pc.dim_e,
                                                  pc.l1_kind)
    x = torch.tensor(np.random.default_rng(0).standard_normal(mesh.n_nodes))
    assert torch.equal(pc.apply(x), pc2.apply(x))
    b = torch.tensor(ap.a_csr @ np.arange(1.0, mesh.n_nodes + 1))
    r1 = cg_solve(pc.batch.matvec, b, pc.apply, rtol=1e-8)
    r2 = cg_solve(pc2.batch.matvec, b, pc2.apply, rtol=1e-8)
    assert r1.its == r2.its and torch.equal(r1.x, r2.x)

    jmesh = jax_laplacian.get_input(args)
    jd = jax_decompose(jmesh, 4, add_overlap=1)
    jap = jax_assemble(jmesh, jd)
    jg = JaxGenEOOptions()
    jg.lvl1, jg.lvl2 = "SORAS", "H2"
    jpc, _ = jax_setup(jap.batch, jg, decomp=jd)
    jax_save_pc(str(tmp_path / "jax.npz"), jpc)
    jpc2 = jax_load_pc(str(tmp_path / "jax.npz"))
    jb = jnp.asarray(np.asarray(b))
    jr = jax.jit(lambda bb: jax_cg(jpc2.batch.matvec, bb, jpc2.apply,
                                   rtol=1e-8))(jb)
    assert r2.its == int(jr.its) and pc2.dim_e == jpc2.dim_e


def test_load_refuses_foreign_classes(tmp_path):
    """A checkpoint names the classes it rebuilds; only this package's
    dataclasses are accepted."""
    torch.save({"format": 1, "tensors": {},
                "tree": {"class": "subprocess:Popen", "fields": {}}},
               tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="not part of"):
        ck.load_setup_tree(str(tmp_path / "bad.pt"), CPU)
    with pytest.raises(TypeError):
        ck.save_pc(str(tmp_path / "x.pt"), object())


def test_structured_warm_setup_matches_cold_and_jax(tmp_path, monkeypatch):
    """checkpoint_dir: the second structured solve loads the saved setup
    (FDM factors, Z, the coarse factorization) and skips the eigensolve;
    the same iterations and solution as the cold run, and as the JAX
    package's run with GENEO_CHECKPOINT_DIR."""
    grid = laplacian_grid(12, dim=3, kappa_max=100.0, interp="minmax")
    outs = []
    for _ in range(2):
        g = GenEOOptions()
        g.lvl1, g.lvl2 = "ASM", "E1"
        outs.append(solve_structured(grid, (2, 2, 1), 2, geneo=g,
                                     ksp=KSPOptions(type="cg"), tol=1e-8,
                                     dtype=torch.float64, device=CPU,
                                     checkpoint_dir=str(tmp_path / "port")))
    cold, warm = outs
    assert len(list((tmp_path / "port").iterdir())) == 1
    assert warm.timers.get("checkpoint_hit") > 0
    assert warm.timers.get("l2_eig") == 0.0 < cold.timers.get("l2_eig")
    assert (warm.refined.outer_its, warm.its) == (cold.refined.outer_its,
                                                  cold.its)
    np.testing.assert_array_equal(warm.x, cold.x)
    np.testing.assert_array_equal(warm.stats.real_dim_e,
                                  cold.stats.real_dim_e)

    monkeypatch.setenv("GENEO_CHECKPOINT_DIR", str(tmp_path / "jax"))
    jg = JaxGenEOOptions()
    jg.lvl1, jg.lvl2 = "ASM", "E1"
    jout = jax_solve_structured(
        jax_grid(12, dim=3, kappa_max=100.0, interp="minmax"), (2, 2, 1), 2,
        geneo=jg, ksp=JaxKSPOptions(type="cg"), tol=1e-8,
        dtype=jnp.float64)
    assert warm.its == jout.its
    np.testing.assert_array_equal(warm.stats.real_dim_e,
                                  jout.stats.real_dim_e)


def test_elastic_warm_setup_matches_cold(tmp_path):
    """The elastic setup product (the PCG level-1 solver with its Robin
    and surrogate-FDM operators, Z, E) round-trips: the warm solve
    repeats the cold one bit for bit; a different configuration misses."""
    grid = el.elastic_grid(6, kappa_max=1000.0, interp="minmax")
    outs = []
    for lvl in ("SORAS,E2", "SORAS,E2", "ASM,E1"):
        o = GenEOOptions()
        o.lvl1, o.lvl2 = lvl.split(",")
        outs.append(el.solve_elastic(grid, (2, 2, 1), 1, o, device=CPU,
                                     checkpoint_dir=str(tmp_path)))
    cold, warm, other = outs
    assert len(list(tmp_path.iterdir())) == 2
    assert warm.timers.get("checkpoint_hit") > 0
    assert other.timers.get("checkpoint_hit") == 0
    assert type(warm.pc.l1.st).__name__ == "RobinOp"
    assert (warm.refined.outer_its, warm.its) == (cold.refined.outer_its,
                                                  cold.its)
    np.testing.assert_array_equal(warm.x, cold.x)
    np.testing.assert_array_equal(warm.stats.real_dim_e,
                                  cold.stats.real_dim_e)
