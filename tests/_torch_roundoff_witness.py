"""Witnesses for the rounding bands that ROADMAP Queue 3 records (two of
tests/test_torch_lobpcg_generic.py, one of tests/test_torch_soras_e2_cg.py,
one of tests/test_torch_cli_multidevice.py), with JAX on the CPU:

1. prune: SORAS,2 with ``-els2_type lobpcg`` and no cut, laplacian
   ``--size S --dim 2 --kappa 1000. minmax``, 4 domains, overlap 1, both
   packages from the same start block ``jax.random.normal(PRNGKey(key))``
   for keys 0-3 at S = 16 and key 0 at S = 12, 20, 24: per-domain real
   dim_e, pruned columns, CG iterations to 1e-8, and the smallest pivots
   of the pivoted Cholesky of E beside the prune floor.
2. float32 refinement: ``test_float32_refined_solve_matches_jax`` at
   sizes 16 and 32 with torch's intra-op threads 1, 2, 4 and 8: the
   inner iterations of each package.
3. soras: SORAS,E2 with ``-els2_type lobpcg`` under CG, laplacian
   ``--size 32 --dim 2 --kappa 10000. minmax``, 8 domains, overlap 1,
   rtol 1e-8 (tests/test_torch_soras_e2_cg.py): CG iterations and reason
   of JAX's PC through JAX's CG and through the port's, and of each
   package's own PC from the start blocks of keys 0-5, then of keys 0-2
   with the eigenvectors converged further (400 LOBPCG iterations,
   tolerance 1e-9); the port's set-up on the test's pinned thread count,
   and for key 0 on 1, 2, 4 and 8 torch threads.
4. ranks: the structured STRUCTURED_CONFIGS of
   tests/test_torch_cli_multidevice.py on 1, 2, 4 and 8 ranks (devices):
   the float32 inner iterations at the roundoff floor through each
   package's CLI (``--nbDevices``; JAX on its 8-device CPU mesh), and
   each package's (inner, outer) counts with a float64 inner CG
   (solve_structured(dtype=float64, n_devices=...)), where they agree.

    python tests/_torch_roundoff_witness.py [--quick] [prune|float32|soras|ranks]

``--quick`` compiles the JAX side with ``jax_disable_most_optimizations``
as the test file does (which changes JAX's start block and arithmetic in
the last bits)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
if "--quick" in sys.argv:
    jax.config.update("jax_disable_most_optimizations", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.linalg.lapack import dpstrf  # noqa: E402

import geneo4petsc_tpu.ops.lobpcg as jax_lobpcg  # noqa: E402
import test_torch_lobpcg_generic as t  # noqa: E402
from geneo4petsc_tpu.assembly.assemble import assemble as jax_assemble  # noqa: E402
from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions  # noqa: E402
from geneo4petsc_tpu.krylov.cg import cg_solve as jax_cg_solve  # noqa: E402
from geneo4petsc_tpu.models import laplacian as jax_laplacian  # noqa: E402
from geneo4petsc_tpu.partition.decompose import \
    partition_and_decompose as jax_partition_and_decompose  # noqa: E402
from geneo4petsc_tpu.precond import geneo as jax_geneo  # noqa: E402
from geneo4petsc_tpu_torch.assembly.assemble import assemble  # noqa: E402
from geneo4petsc_tpu_torch.config import GenEOOptions  # noqa: E402
from geneo4petsc_tpu_torch.krylov.cg import cg_solve  # noqa: E402
from geneo4petsc_tpu_torch.models import laplacian  # noqa: E402
from geneo4petsc_tpu_torch.partition.decompose import \
    partition_and_decompose  # noqa: E402
from geneo4petsc_tpu_torch.precond import geneo  # noqa: E402
from _threads import torch_threads  # noqa: E402

CPU = torch.device("cpu")


def _spy_prune(module, seen, tag):
    """Record the smallest pivots of E's pivoted Cholesky and the floor."""
    prune = module.prune_dependent_columns

    def spy(e, dtype):
        tol = e.shape[0] * np.finfo(dtype).eps * float(np.diagonal(e).max())
        c, _piv, rank, _ = dpstrf(np.array(e), lower=1, tol=tol)
        pivots = np.sort(np.diagonal(c)[:int(rank)] ** 2)[:2]
        seen[tag] = f"rank {int(rank)}/{e.shape[0]}, smallest pivots " \
                    f"{pivots[0]:.3e} {pivots[1]:.3e}, floor {tol:.3e}"
        return prune(e, dtype)

    module.prune_dependent_columns = spy


def prune(size: int, key: int) -> None:
    args = f"--size {size} --dim 2 --kappa 1000. minmax"
    ref_mesh, mesh = jax_laplacian.get_input(args), laplacian.get_input(args)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 4, add_overlap=1))
    got = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=1), CPU)
    g, jg = GenEOOptions(), JaxGenEOOptions()
    for o in (g, jg):
        o.lvl1, o.lvl2, o.cut = "SORAS", "2", 0
        o.els2.type = "lobpcg"
    seen = {}
    _spy_prune(jax_geneo, seen, "jax")
    _spy_prune(geneo, seen, "port")
    prng = jax.random.PRNGKey
    # JAX's draw is traced into its compiled setup: drop the programs
    # compiled for an earlier key
    jax.clear_caches()
    jax_lobpcg.jax.random.PRNGKey = lambda _seed: prng(key)
    try:
        ref_pc, ref_st = jax_geneo.setup_geneo(ref.batch, jg,
                                               decomp=ref.decomp,
                                               a_csr=ref.a_csr)
    finally:
        jax_lobpcg.jax.random.PRNGKey = prng

    def start(d, n, k, dtype):
        return torch.from_numpy(np.array(jax.random.normal(
            prng(key), (d, n, k), jnp.float64)))

    geneo.default_start = start
    pc, st = geneo.setup_geneo(got.batch, g, decomp=got.decomp,
                               a_csr=got.a_csr)
    rhs = np.random.default_rng(1).standard_normal(got.n_dof)
    ref_res = jax_cg_solve(ref_pc.batch.matvec, jnp.asarray(rhs),
                           ref_pc.apply, rtol=1e-8)
    res = cg_solve(got.batch.matvec, torch.from_numpy(rhs), pc.apply,
                   rtol=1e-8)
    print(f"prune size {size} key {key}: raw dim_e equal "
          f"{np.array_equal(st.raw_dim_e, ref_st.raw_dim_e)}; real dim_e "
          f"JAX {ref_st.real_dim_e.tolist()} port {st.real_dim_e.tolist()}; "
          f"pruned JAX {ref_st.e_pruned} port {st.e_pruned}; CG its JAX "
          f"{int(ref_res.its)} port {res.its}", flush=True)
    for tag in ("jax", "port"):
        print(f"    {tag}: {seen[tag]}", flush=True)


def float32_refinement() -> None:
    counts = {}
    solve, jax_solve = t.refined_solve, t.jax_refined_solve

    def spy(*a, **kw):
        r = solve(*a, **kw)
        counts["port"] = r.inner_its
        return r

    def jax_spy(*a, **kw):
        r = jax_solve(*a, **kw)
        counts["jax"] = r.inner_its
        return r

    t.refined_solve, t.jax_refined_solve = spy, jax_spy
    for size in (16, 32):
        for threads in (1, 2, 4, 8):
            try:
                with torch_threads(threads):
                    t.test_float32_refined_solve_matches_jax(size)
                held = "held"
            except AssertionError:
                held = "NOT held"
            print(f"float32 refinement size {size}, torch threads "
                  f"{threads}: inner JAX {counts['jax']} port "
                  f"{counts['port']} (band +-3 {held})", flush=True)


def soras() -> None:
    import test_torch_soras_e2_cg as w
    from geneo4petsc_tpu_torch.utils.convert import pc_from_arrays

    ref_mesh = jax_laplacian.get_input(w.ARGS)
    ref = jax_assemble(ref_mesh, jax_partition_and_decompose(
        ref_mesh, 8, add_overlap=1))
    mesh = laplacian.get_input(w.ARGS)
    got = assemble(mesh, partition_and_decompose(mesh, 8, add_overlap=1),
                   CPU)
    b = np.asarray(ref.a_csr @ np.arange(1.0, mesh.n_nodes + 1))
    prng = jax.random.PRNGKey
    for max_it, tol, keys in ((None, None, range(6)), (400, 1e-9, range(3))):
        for key in keys:
            def opts(cls):
                g = w._opts(cls)
                if max_it:
                    g.els2.max_it, g.els2.rtol = max_it, tol
                return g

            jax_lobpcg.jax.random.PRNGKey = lambda _seed: prng(key)
            jax.clear_caches()
            try:
                jpc, _ = jax_geneo.setup_geneo(
                    ref.batch, opts(JaxGenEOOptions), b=jnp.asarray(b),
                    decomp=ref.decomp, a_csr=ref.a_csr)
            finally:
                jax_lobpcg.jax.random.PRNGKey = prng
            r = jax_cg_solve(jpc.batch.matvec, jnp.asarray(b), jpc.apply, x0=jpc.x0,
                    rtol=1e-8)
            line = (f"soras key {key}{' converged further' if max_it else ''}"
                    f": JAX PC / JAX CG {int(r.its)} ({int(r.reason)})")
            if key == 0 and not max_it:
                d, meta = _pc_arrays(jpc)
                conv = pc_from_arrays(d, meta, CPU)
                rc = cg_solve(conv.batch.matvec, torch.from_numpy(b),
                              conv.apply, x0=conv.x0, rtol=1e-8)
                line += f", JAX PC / port CG {rc.its} ({rc.reason})"
            print(line, flush=True)
            start = geneo.default_start
            geneo.default_start = lambda d, n, k, dt: torch.from_numpy(
                np.array(jax.random.normal(prng(key), (d, n, k),
                                           jnp.float64))).to(dt)
            counts = (1, 2, 4, 8) if key == 0 and not max_it else \
                (w.PINNED_THREADS,)
            try:
                for threads in counts:
                    with torch_threads(threads):
                        pc, _ = geneo.setup_geneo(
                            got.batch, opts(GenEOOptions),
                            b=torch.from_numpy(b), decomp=got.decomp,
                            a_csr=got.a_csr)
                    rp = cg_solve(pc.batch.matvec, torch.from_numpy(b),
                                  pc.apply, x0=pc.x0, rtol=1e-8)
                    print(f"  port PC (set-up on {threads} torch threads) / "
                          f"port CG {rp.its} ({rp.reason})", flush=True)
            finally:
                geneo.default_start = start


def _pc_arrays(jpc):
    def leaf(a):
        return None if a is None else np.asarray(a)

    bt, l1 = jpc.batch, jpc.l1_factor
    d = {"gids": leaf(bt.gids), "mask": leaf(bt.mask), "mult": leaf(bt.mult),
         "a_neu": leaf(bt.a_neu), "a_dir": leaf(bt.a_dir), "n_dof": bt.n_dof,
         "l1_factor": tuple(map(leaf, l1)) if isinstance(l1, tuple)
         else leaf(l1), "pou": leaf(jpc.pou), "z_loc": leaf(jpc.z_loc),
         "colids": leaf(jpc.colids), "e_evecs": leaf(jpc.e_evecs),
         "e_eig_inv": leaf(jpc.e_eig_inv), "x0": leaf(jpc.x0)}
    return d, {k: getattr(jpc, k) for k in ("lvl1", "lvl2", "hybrid",
                                            "eff_hybrid", "dim_e", "k_max",
                                            "l1_kind")}


def ranks() -> None:
    import io
    import re

    from geneo4petsc_tpu import cli as jax_cli
    from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
    from geneo4petsc_tpu.structured import grid as jax_grid
    from geneo4petsc_tpu.structured.solve import \
        solve_structured as jax_solve
    from geneo4petsc_tpu_torch import cli
    from geneo4petsc_tpu_torch.config import KSPOptions
    from geneo4petsc_tpu_torch.structured import grid as tgrid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured
    import test_torch_cli_multidevice as m

    def its(run, args):
        buf = io.StringIO()
        run(args, out=buf)
        got = re.search(r"(\d+) iteration\(s\)", buf.getvalue())
        return got.group(1) if got else buf.getvalue()

    for wl, lvl, _ndev, _band in m.STRUCTURED_CONFIGS:
        args = ["--inpLibA", wl, "--inpLibArg",
                "--size 16#--dim 3#--kappa 100. minmax", "--structured",
                "2,2,2", "--addOverlap", "1", "-pc_type", "geneo",
                "-geneo_lvl", lvl, "-ksp_type", "cg", "-ksp_rtol", "1e-8"]
        for n in (1, 2, 4, 8):
            dev = ["--nbDevices", str(n)]
            f32 = (its(cli.run, args + ["--device", "cpu"] + dev),
                   its(jax_cli.run, args + dev))
            f64 = []
            for solve, grids, opts, ksp, dtype, kw in (
                    (solve_structured, tgrid, GenEOOptions, KSPOptions,
                     torch.float64, {"device": "cpu"}),
                    (jax_solve, jax_grid, JaxGenEOOptions, JaxKSPOptions,
                     jnp.float64, {})):
                g = opts()
                g.lvl1, g.lvl2 = lvl.split(",")
                out = solve(getattr(grids, f"{wl}_grid")(
                    16, dim=3, kappa_max=100.0, interp="minmax"), (2, 2, 2),
                    1, geneo=g, ksp=ksp(type="cg", rtol=1e-8), dtype=dtype,
                    n_devices=n, **kw)
                f64.append((out.refined.inner_its, out.refined.outer_its))
            print(f"ranks {wl} {lvl} on {n}: float32 inner port {f32[0]}, "
                  f"JAX {f32[1]}; float64 (inner, outer) port {f64[0]}, "
                  f"JAX {f64[1]}", flush=True)


if __name__ == "__main__":
    which = [a for a in sys.argv[1:] if not a.startswith("--")] or [
        "prune", "float32", "soras", "ranks"]
    if "prune" in which:
        for key in range(4):
            prune(16, key)
        for size in (12, 20, 24):
            prune(size, 0)
    if "float32" in which:
        float32_refinement()
    if "soras" in which:
        soras()
    if "ranks" in which:
        ranks()
