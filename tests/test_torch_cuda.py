"""Tests of the PyTorch port that need a CUDA card; each skips without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)  Tolerances:
the kernels against their plain versions, max relative error 1e-12 in
float64 and 1e-5 in float32 (the sums run in another order); the cpu
and cuda solves, equal iteration counts and solutions within 1e-10."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from geneo4petsc_tpu_torch.config import DriverOptions, GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.models import laplacian
from geneo4petsc_tpu_torch.ops import local_kernels as lk
from geneo4petsc_tpu_torch.solver import solve_mesh

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(d, n, device, dtype, seed=0, aligned=True):
    """Seeded inputs; ``aligned=False`` puts the matrix batch one element
    into a longer buffer, so that its base pointer is no multiple of 16
    bytes and the kernels must take their direct path."""
    rng = np.random.default_rng(seed)
    inv = torch.from_numpy(rng.standard_normal((d, n, n))).to(device, dtype)
    pou = torch.from_numpy(rng.random((d, n)) + 0.5)
    mask = torch.from_numpy(rng.random((d, n)) > 0.2)
    x = torch.from_numpy(rng.standard_normal((d, n)))
    if not aligned:
        buf = torch.empty(inv.numel() + 1, dtype=dtype, device=device)
        buf[1:].copy_(inv.flatten())
        inv = buf[1:].view(d, n, n)
        assert inv.data_ptr() % 16 != 0 and inv.is_contiguous()
    return (inv, pou.to(device, dtype), mask.to(device), x.to(device, dtype))


def _rel(got, want):
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-300))


def _expected_path(inv):
    """The ring takes batches whose base pointer and row size are
    multiples of 16 bytes (and whose rows fit shared memory, as all of
    these do); every other batch goes the direct path."""
    row_bytes = inv.shape[1] * inv.element_size()
    ring = inv.data_ptr() % 16 == 0 and row_bytes % 16 == 0
    return "ring" if ring else "direct"


SHAPES = [(7, 53), (1, 1), (33, 300), (3, 37), (7, 50), (5, 66), (5, 64),
          (133, 496), (2, 3000), (1024, 496)]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernels_match_plain(cuda, dtype, shape, aligned):
    inv, pou, mask, x = _data(*shape, cuda, dtype, aligned=aligned)
    assert lk.plan_for(inv).path == _expected_path(inv)
    if not aligned:
        assert lk.plan_for(inv).path == "direct"
    for pre, post in [(False, False), (True, False), (False, True),
                      (True, True)]:
        before = lk.fused_local_solve.launches
        got = lk.fused_local_solve(inv, pou, mask, x, pre, post)
        assert lk.fused_local_solve.launches == before + 1
        want = lk.fused_local_solve_plain(inv, pou, mask, x, pre, post)
        assert _rel(got, want) <= TOL[dtype]
    before = lk.block_matvec.launches
    got = lk.block_matvec(inv, x)
    assert lk.block_matvec.launches == before + 1
    assert _rel(got, lk.block_matvec_plain(inv, x)) <= TOL[dtype]


@pytest.mark.parametrize("aligned,path", [(True, "ring"), (False, "direct")],
                         ids=["ring", "direct"])
def test_kernels_are_bitwise_reproducible_on_cuda(cuda, aligned, path):
    inv, pou, mask, x = _data(133, 496, cuda, torch.float64, aligned=aligned)
    assert lk.plan_for(inv).path == path
    first = (lk.block_matvec(inv, x),
             lk.fused_local_solve(inv, pou, mask, x, True, True))
    for _ in range(3):
        assert torch.equal(lk.block_matvec(inv, x), first[0])
        assert torch.equal(
            lk.fused_local_solve(inv, pou, mask, x, True, True), first[1])


def test_kernel_refuses_a_plan_that_does_not_fit(cuda):
    inv, _, _, x = _data(7, 50, cuda, torch.float64)
    plan = lk.plan_for(inv)
    assert plan.path == "ring"
    with pytest.raises(RuntimeError, match="CUDA error"):
        lk._block_matvec_cuda(inv, x, plan._replace(smem=plan.smem + 16))
    odd = _data(3, 37, cuda, torch.float64)[0]
    with pytest.raises(RuntimeError, match="CUDA error"):   # 296-byte rows
        lk._block_matvec_cuda(odd, x[:3, :37].contiguous(),
                              plan._replace(grid=3))


def test_kernel_refuses_mixed_devices(cuda):
    inv, pou, mask, x = _data(3, 8, cuda, torch.float64)
    with pytest.raises(ValueError, match="on cpu"):
        lk.fused_local_solve(inv, pou, mask.cpu(), x)


def test_scatter_add_is_bitwise_reproducible_on_cuda(cuda):
    from geneo4petsc_tpu_torch.assembly.assemble import assemble
    from geneo4petsc_tpu_torch.partition.decompose import (
        partition_and_decompose)

    mesh = laplacian.get_input("--size 16 --dim 2")
    batch = assemble(mesh, partition_and_decompose(mesh, 4, add_overlap=2),
                     cuda).batch
    xl = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch.n_dom, batch.n_max))).to(cuda)
    assert torch.equal(batch.scatter_add(xl), batch.scatter_add(xl.clone()))


def test_solve_on_cuda_matches_cpu(cuda):
    mesh = laplacian.get_input("--size 16 --dim 2 --kappa 100. minmax")
    g = GenEOOptions()
    g.lvl1, g.lvl2 = "ASM", "E1"
    g.dls1.type = "inverse_pallas"
    kw = dict(n_dom=4, geneo=g, ksp=KSPOptions(type="cg", rtol=1e-8),
              driver=DriverOptions(add_overlap=1))
    ref = solve_mesh(mesh, torch.device("cpu"), **kw)
    k1, k2 = lk.fused_local_solve.launches, lk.block_matvec.launches
    got = solve_mesh(mesh, cuda, **kw)
    assert got.result.x.device.type == "cuda"
    assert (got.its, got.result.reason) == (ref.its, ref.result.reason)
    assert np.linalg.norm(got.x - ref.x) <= 1e-10 * np.linalg.norm(ref.x)
    assert lk.fused_local_solve.launches - k1 >= got.its
    assert lk.block_matvec.launches - k2 >= 2 * got.its


# ---------------- the structured path on the card ----------------

def _structured(size, dim, dg, overlap, device, dtype=torch.float64):
    from geneo4petsc_tpu_torch.structured import local_ops as lo
    from geneo4petsc_tpu_torch.structured.decompose import (
        StructuredDecomposition)
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid

    sd = StructuredDecomposition(laplacian_grid(
        size, dim=dim, kappa_max=1e4, interp="minmax"), dg, overlap)
    pad1 = tuple(p + 1 if g > 1 else 0 for p, g in zip(sd.pad, sd.dom_grid))
    return sd, lo.slice_inner(lo.gather_fields(sd, dtype, pad=pad1,
                                               device=device), sd)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_structured_scatter_add_is_bitwise_reproducible(cuda, dtype):
    from geneo4petsc_tpu_torch.structured import halo

    grid, dg, pad = (48, 48, 48), (4, 4, 2), (2, 2, 2)
    n_dom, box = 32, (48 // 2 + 4, 48 // 4 + 4, 48 // 4 + 4)
    yl = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n_dom,) + box)).to(cuda, dtype)
    blocks = halo.from_batch(yl, dg)
    first = halo.halo_scatter_add(blocks, grid, dg, pad)
    for _ in range(3):
        assert torch.equal(halo.halo_scatter_add(blocks.clone(), grid, dg,
                                                 pad), first)
    want = halo.halo_scatter_add(blocks.cpu().double(), grid, dg, pad)
    assert _rel(first.double().cpu(), want) <= TOL[dtype]


def test_structured_stencils_and_fdm_on_cuda_match_cpu(cuda):
    from geneo4petsc_tpu_torch.structured import fdm
    from geneo4petsc_tpu_torch.structured import local_ops as lo
    from geneo4petsc_tpu_torch.structured.grid import global_stencil

    sd, f_cpu = _structured(24, 3, (2, 2, 2), 2, torch.device("cpu"))
    _, f_gpu = _structured(24, 3, (2, 2, 2), 2, cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2,) + tuple(f_cpu.diag.shape))).transpose(0, 1).contiguous()
    xg = torch.from_numpy(np.random.default_rng(4).standard_normal(
        sd.grid.n_nodes))
    got = global_stencil(sd.grid, torch.float64, cuda).matvec(xg.to(cuda))
    want = global_stencil(sd.grid, torch.float64, "cpu").matvec(xg)
    assert _rel(got.cpu(), want) <= 1e-14
    for make in (lo.neumann_stencil, lo.dirichlet_stencil):
        assert _rel(make(f_gpu).matvec(x.to(cuda)).cpu(),
                    make(f_cpu).matvec(x)) <= 1e-14
    ax = fdm.dirichlet_axes(sd)
    got = fdm.fdm_factor(ax, dtype=torch.float64, device=cuda).solve(
        x.to(cuda))
    want = fdm.fdm_factor(ax, dtype=torch.float64, device="cpu").solve(x)
    assert _rel(got.cpu(), want) <= 1e-12


@pytest.mark.parametrize("device_refine", [False, True],
                         ids=["host-refine", "device-refine"])
def test_structured_solve_on_cuda_matches_cpu(cuda, device_refine):
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured

    g = GenEOOptions()
    g.lvl1, g.lvl2 = "ASM", "E1"
    g.els2.type, g.cut = "lobpcg", 2
    kw = dict(geneo=g, ksp=KSPOptions(type="cg"), tol=1e-8,
              dtype=torch.float64, device_refine=device_refine)
    grid = laplacian_grid(24, dim=3, kappa_max=1e4, interp="minmax")
    ref = solve_structured(grid, (2, 2, 2), 2, device="cpu", **kw)
    got = solve_structured(grid, (2, 2, 2), 2, device=cuda, **kw)
    assert got.pc.z.device.type == "cuda"
    assert got.converged and got.true_res <= 1e-8
    np.testing.assert_array_equal(got.stats.real_dim_e,
                                  ref.stats.real_dim_e)
    np.testing.assert_array_equal(got.stats.nicolaides,
                                  ref.stats.nicolaides)
    assert abs(got.its - ref.its) <= 1
    assert got.refined.outer_its == ref.refined.outer_its


# ---------------- the LOBPCG start block drawn on the card ----------------

def _ulp_ok(got, want, ulps):
    """|got - want| within ``ulps`` units in the last place of want."""
    spacing = torch.from_numpy(np.spacing(np.abs(want.cpu().numpy())))
    return bool(((got - want).abs().cpu() <= ulps * spacing).all())


@pytest.mark.parametrize("case", ["lap10m-f32", "ragged-f64"])
def test_start_draw_kernel_matches_plain(cuda, case):
    """The start-block kernel against its plain version on the card: at
    lap10m's shape ([64, 2, 195112] float32, the mask of its 4x4x4
    boxes with overlap 2) within 2 units in the last place (the same
    log1pf; float64-rounded against fused multiply-adds), and at a
    float64 shape with a ragged n within 1e-14 relative, against the CPU
    route too; masked slots are zeros and two launches give the same
    bits."""
    from geneo4petsc_tpu_torch.ops import start_draw as tdraw

    if case == "lap10m-f32":
        _, f = _structured(216, 3, (4, 4, 4), 2, cuda, torch.float32)
        mask, k = f.mask.to(torch.float32).reshape(64, -1), 2
        assert mask.shape == (64, 195112)
    else:
        mask = torch.from_numpy(np.random.default_rng(4).random(
            (5, 12345)) > 0.3).to(cuda, torch.float64)
        k = 3
    launches = tdraw.start_draw.launches
    got = tdraw.start_draw(mask, k)
    again = tdraw.start_draw(mask, k)
    torch.cuda.synchronize()
    assert tdraw.start_draw.launches == launches + 2
    assert got.shape == (mask.shape[0], k, mask.shape[1])
    assert got.is_cuda and got.is_contiguous() and torch.equal(got, again)
    assert (got.transpose(1, 2)[mask == 0] == 0).all()
    want = tdraw.start_draw_plain(mask, k)
    if mask.dtype == torch.float32:
        assert _ulp_ok(got, want, 2)
    else:
        assert _rel(got, want) <= 1e-14
        assert _rel(got.cpu(), tdraw.start_draw(mask.cpu(), k)) <= 1e-14


def test_start_draw_launches_once_per_pencil_chunk(cuda, monkeypatch):
    """setup_structured without a lobpcg_start launches the kernel once
    per LOBPCG run: ASM,E1 (one pencil) over 8 domains in chunks of 3 is
    3 launches; a given lobpcg_start launches none."""
    from geneo4petsc_tpu_torch.ops import start_draw as tdraw
    from geneo4petsc_tpu_torch.ops.start_draw import jax_start
    from geneo4petsc_tpu_torch.structured import geneo as tgeneo

    sd, _ = _structured(16, 3, (2, 2, 2), 2, "cpu")
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2 = "ASM", "E1"
    opts.els2.type, opts.cut = "lobpcg", 2
    per_dom = int(np.prod(sd.local_shape)) * 16 * 2 * 4
    monkeypatch.setattr(tgeneo, "LOBPCG_BUDGET_BYTES", 3 * per_dom)
    launches = tdraw.start_draw.launches
    _, st = tgeneo.setup_structured(sd, opts, dtype=torch.float64,
                                    device=cuda)
    assert tdraw.start_draw.launches == launches + 3
    _, st_cb = tgeneo.setup_structured(sd, opts, dtype=torch.float64,
                                       device=cuda, lobpcg_start=jax_start)
    assert tdraw.start_draw.launches == launches + 3
    np.testing.assert_array_equal(st.real_dim_e, st_cb.real_dim_e)


def test_start_draw_raises_on_a_refused_launch(cuda):
    """A launch the card refuses (2048 threads a block) comes back as the
    C entry point's cudaGetLastError and raises; the card works on."""
    from geneo4petsc_tpu_torch.ops import start_draw as tdraw

    mask = torch.ones((2, 300), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tdraw._start_draw_cuda(mask, 2, threads=2048)
    assert _ulp_ok(tdraw.start_draw(mask, 2), tdraw.start_draw_plain(mask, 2),
                   2)


def _generic_batch(device, args="--size 16 --dim 2 --kappa 1000. minmax",
                   n_dom=4, dtype=torch.float64):
    from geneo4petsc_tpu_torch.assembly.assemble import assemble
    from geneo4petsc_tpu_torch.partition.decompose import (
        partition_and_decompose)

    mesh = laplacian.get_input(args)
    return assemble(mesh, partition_and_decompose(mesh, n_dom,
                                                  add_overlap=1),
                    device, dtype=dtype)


@pytest.mark.parametrize("pc_type", ["bjacobi-ilu", "bjacobi-exact",
                                     "mg-v", "mg-w"])
def test_comparison_pcs_bitwise_reproducible_and_match_cpu(cuda, pc_type):
    from geneo4petsc_tpu_torch.precond.bjacobi import setup_bjacobi
    from geneo4petsc_tpu_torch.precond.mg import setup_mg

    a = _generic_batch("cpu", "--size 32 --dim 2 --kappa 1000. minmax").a_csr
    kind, sub = pc_type.split("-")

    def make(device):
        if kind == "bjacobi":
            return setup_bjacobi(a, 4, device, torch.float64, sub_type=sub)
        return setup_mg(a, device, torch.float64, coarse_max=64,
                        cycle_type=sub, smooth_down=5, smooth_up=5)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        a.shape[0]))
    pc = make(cuda)
    got = [pc.apply(x.to(cuda)) for _ in range(3)]
    assert all(torch.equal(got[0], g) for g in got[1:])
    assert _rel(got[0].cpu(), make("cpu").apply(x)) <= 1e-12


def test_batched_lobpcg_bitwise_reproducible_and_matches_cpu(cuda):
    from geneo4petsc_tpu_torch.ops.lobpcg import batched_lobpcg
    from geneo4petsc_tpu_torch.precond import geneo

    batch = _generic_batch(cuda).batch
    a, b = geneo._pencil_tau_device(batch, 1e6)
    runs = [batched_lobpcg(a, b, 4, max_it=50, shift=0.1) for _ in range(2)]
    for t0, t1 in zip(*runs):
        assert torch.equal(t0, t1)
    w, _, res = batched_lobpcg(a.cpu(), b.cpu(), 4, max_it=50, shift=0.1)
    assert _rel(runs[0][0].cpu(), w) <= 1e-8
    assert float(runs[0][2].max()) <= 10 * float(res.max()) + 1e-8


@pytest.mark.parametrize("theta", [0.05, 0.1, 0.4])
def test_ldlt_inertia_on_cuda_equals_plain(cuda, theta):
    from geneo4petsc_tpu_torch.ops import batched_linalg as bl
    from geneo4petsc_tpu_torch.precond import geneo

    batch = _generic_batch("cpu", "--size 32 --dim 2 --kappa 1e4 minmax",
                           n_dom=8).batch
    a, b = geneo._pencil_tau_device(batch, 1e6)
    s = a - theta * b
    # the plain version: the same factorization on the host
    want = bl.ldlt_inertia(s, batch.mask)
    got = bl.ldlt_inertia(s.to(cuda), batch.mask.to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_pencils_built_on_cuda_equal_host_forms(cuda):
    from geneo4petsc_tpu_torch.precond import geneo

    batch = _generic_batch(cuda).batch
    mask = batch.mask.cpu().numpy()
    a_neu, a_dir = batch.a_neu.cpu().numpy(), batch.a_dir.cpu().numpy()
    d = 1.0 / batch.mult.cpu().numpy()
    dadird = a_dir * d[:, :, None] * d[:, None, :]
    a_rob = geneo.robin_blocks(batch, 0.3).cpu().numpy()
    want = {"tau1": (geneo._with_pad_diag(a_neu, mask, 1e6), dadird),
            "tau": (geneo._with_pad_diag(a_neu, mask, 1e6), a_rob),
            "gamma": (geneo._with_pad_diag(a_rob, mask, 1e6), dadird)}
    got = {"tau1": geneo._pencil_tau_device(batch, 1e6),
           "tau": geneo._pencil_g2_device(batch, 0.3, "tau"),
           "gamma": geneo._pencil_g2_device(batch, 0.3, "gamma")}
    for key, (ga, gb) in got.items():
        assert ga.device.type == "cuda"
        np.testing.assert_allclose(ga.cpu().numpy(), want[key][0],
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(gb.cpu().numpy(), want[key][1],
                                   rtol=1e-15, atol=0)


@pytest.mark.parametrize("lvl,ksp", [("ASM,E1", "cg"), ("SORAS,2", "gmres")])
def test_lobpcg_setup_on_cuda_matches_cpu(cuda, lvl, ksp):
    """-els2_type lobpcg without a cut: the inertia counts, the kept
    columns and the iterations are the same on both devices (SORAS is
    not symmetric: GMRES, as the reference runs it; under CG its count
    hangs on roundoff, 28 on the host and 29 on the card)."""
    g = GenEOOptions()
    g.lvl1, g.lvl2 = lvl.split(",")
    g.els2.type = "lobpcg"
    kw = dict(n_dom=8, pc_type="geneo", geneo=g,
              ksp=KSPOptions(type=ksp, rtol=1e-8),
              driver=DriverOptions(add_overlap=1))
    mesh = laplacian.get_input("--size 32 --dim 2 --kappa 10000. minmax")
    ref = solve_mesh(mesh, torch.device("cpu"), **kw)
    got = solve_mesh(mesh, cuda, **kw)
    np.testing.assert_array_equal(got.stats.estim_dim_e,
                                  ref.stats.estim_dim_e)
    np.testing.assert_array_equal(got.stats.raw_dim_e, ref.stats.raw_dim_e)
    assert (got.its, got.result.reason) == (ref.its, ref.result.reason)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_elastic_operators_on_cuda_match_cpu_and_repeat_bitwise(cuda, dtype):
    """The elastic cell sums (global, dilated Dirichlet, Neumann, Robin)
    on the card equal the host's (float64: 1e-13, float32: 1e-5; the
    float64 level-1 solve and apply 1e-9) and
    repeated applies give the same bits: the 8 corners and the halo are
    summed by shifted slice adds in a fixed order, no atomics; the
    float32 products run without TF32."""
    from geneo4petsc_tpu_torch.structured import elastic as el

    g = el.elastic_grid(8, kappa_max=1e3, interp="minmax")
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "SORAS", "0"
    o.dls1.rtol, o.dls1.max_it = 1e-11, 500
    pcs = {dev: el.setup_elastic(g, (2, 2, 2), 1, o, dtype=dtype,
                                 device=dev)[0]
           for dev in (torch.device("cpu"), cuda)}
    ref, got = pcs[torch.device("cpu")], pcs[cuda]
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(g.n_dof)).to(dtype)
    for name in ("matvec", "_local_solve", "apply"):
        a = getattr(got, name)(x.to(cuda))
        b = getattr(got, name)(x.to(cuda))
        assert torch.equal(a, b), name
        # the level-1 PCG at rtol 1e-11 (float64; float32 stops at its
        # floor, on a rounding-decided iteration, so only the operator)
        if name == "matvec" or dtype == torch.float64:
            want = getattr(ref, name)(x)
            assert _rel(a.cpu(), want) <= (tol if name == "matvec"
                                           else 1e-9), name
    d, sz, sy, sx = got.maskf.shape
    xb = torch.from_numpy(rng.standard_normal((d, 3, 3, sz, sy, sx))) \
        .to(dtype)
    for op_name in ("dir_op", "neu_op"):
        for m in (xb[:, 0], xb):
            a = getattr(got.l1.st, op_name).matvec(m.to(cuda))
            assert torch.equal(a, getattr(got.l1.st, op_name).matvec(
                m.to(cuda)))
            assert _rel(a.cpu(), getattr(ref.l1.st, op_name).matvec(m)) \
                <= tol
    a = got.l1.st.matvec(xb.to(cuda))
    assert _rel(a.cpu(), ref.l1.st.matvec(xb)) <= tol


def test_elastic_solve_on_cuda_matches_cpu(cuda):
    """solve_elastic in float64 on the card (both refinement routes)
    against the host: equal coarse dimensions and iterations."""
    from geneo4petsc_tpu_torch.structured import elastic as el

    g = el.elastic_grid(6, kappa_max=1e3, interp="minmax")
    o = GenEOOptions()
    o.lvl1, o.lvl2 = "SORAS", "E2"
    o.dls1.rtol, o.dls1.max_it = 1e-11, 500
    ref = el.solve_elastic(g, (2, 2, 1), 1, o, dtype=torch.float64,
                           device="cpu")
    for route in (False, True):
        got = el.solve_elastic(g, (2, 2, 1), 1, o, dtype=torch.float64,
                               device=cuda, device_refine=route)
        assert got.pc.z.device.type == "cuda"
        np.testing.assert_array_equal(got.stats.raw_dim_e,
                                      ref.stats.raw_dim_e)
        assert got.converged and got.true_res <= 1e-8
        assert got.refined.outer_its == ref.refined.outer_its
        assert got.refined.inner_its == ref.refined.inner_its


def test_api_solve_on_cuda_matches_cpu(cuda):
    """make_batch / geneo_setup / geneo_solve on the card: K1 (block
    inverses) and K2 (every matvec) launch, and the solve equals the
    host's."""
    import scipy.sparse as sp

    from geneo4petsc_tpu_torch import api

    n, ov = 12, 2
    a = sp.diags([[-1.0] * (n - 1), [2.0] * n, [-1.0] * (n - 1)],
                 [-1, 0, 1]).tocsr() + sp.eye(n) * 0.01
    g0, g1 = np.arange(0, n // 2 + ov), np.arange(n // 2 - ov, n)
    shared = np.intersect1d(g0, g1)
    mult = np.ones(n)
    mult[shared] = 2.0

    def neu(g):
        w = a.toarray()[np.ix_(g, g)]
        both = np.isin(g, shared)
        w[np.ix_(both, both)] /= 2.0
        return w

    b = a @ np.arange(1.0, n + 1)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        batch = api.make_batch(n, [g0, g1], [neu(g0), neu(g1)],
                               [mult[g0], mult[g1]], device=dev)
        opts = GenEOOptions()
        opts.lvl1, opts.lvl2 = "ASM", "1"
        opts.dls1.type = "inverse_pallas"
        pc, _ = api.geneo_setup(batch, opts, b=b)
        lk.fused_local_solve.launches = lk.block_matvec.launches = 0
        res = api.geneo_solve(batch, b, pc, KSPOptions(type="cg",
                                                       rtol=1e-10))
        out[dev.type] = (res, lk.fused_local_solve.launches,
                         lk.block_matvec.launches)
    (r_cpu, k1_cpu, k2_cpu), (r, k1, k2) = out["cpu"], out["cuda"]
    assert (k1_cpu, k2_cpu) == (0, 0) and k1 >= r.its and k2 >= r.its
    assert (r.its, r.reason) == (r_cpu.its, r_cpu.reason) and r.reason > 0
    np.testing.assert_allclose(r.x.cpu().numpy(), r_cpu.x.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_block_layout_equals_global_on_cuda(cuda, dtype):
    """structured/blockmode.py: the block-major operators equal the
    global-layout ones bit for bit on the card too."""
    from geneo4petsc_tpu_torch.structured.blockmode import build_block_mode
    from geneo4petsc_tpu_torch.structured.decompose import \
        StructuredDecomposition
    from geneo4petsc_tpu_torch.structured.geneo import setup_structured
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
    grid = laplacian_grid(16, dim=3, kappa_max=1e4, interp="minmax")
    sd = StructuredDecomposition(grid, (2, 2, 2), 2)
    opts = GenEOOptions()
    opts.lvl1, opts.lvl2, opts.cut = "RAS", "H1", 2
    pc, _ = setup_structured(sd, opts, dtype=dtype, device=cuda)
    blk = build_block_mode(pc, sd, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        grid.n_nodes)).to(cuda, dtype)
    xb = blk.to_block(x)
    assert torch.equal(blk.from_block(blk.matvec(xb)), pc.matvec(x))
    assert torch.equal(blk.from_block(blk.apply(xb)), pc.apply(x))


def test_nccl_world_one_dist_apply_equals_single(cuda):
    """A world-size-1 NCCL group: dist_geneo's apply and matvec (K1/K2 on
    the rank's chunk) equal the single-device ones, and CG takes the same
    iterations."""
    from geneo4petsc_tpu_torch.parallel import multiproc, probes
    got = multiproc.run_ranks(probes.batch, 1, args=([(
        "generic", ("--size 24 --dim 2 --kappa 1000. minmax", 8, 1,
                    ["ASM,H1"]), {"device": "cuda"})],), device="cuda",
        timeout=600)[0]["ASM,H1"]
    assert _rel(torch.from_numpy(got["apply"]),
                torch.from_numpy(got["apply_1"])) <= 1e-12
    assert _rel(torch.from_numpy(got["matvec"]),
                torch.from_numpy(got["matvec_1"])) <= 1e-12
    assert got["its"] == got["its_1"]


def test_nbdevices_beyond_the_cards_exits_1(cuda, capsys):
    """--nbDevices D --device cuda with fewer than D cards: exit 1 naming
    the card count, and no run on the CPU."""
    from geneo4petsc_tpu_torch import cli
    n = torch.cuda.device_count() + 1
    rc = cli.run(["--inpLibA", "laplacian", "--inpLibArg",
                  "--size#12#--dim#2", "--nbPart", "4", "-pc_type", "geneo",
                  "-geneo_lvl", "ASM,1", "--nbDevices", str(n),
                  "--device", "cuda"])
    err = capsys.readouterr()
    assert rc == 1
    assert f"has {torch.cuda.device_count()}" in err.err
    assert "INFO: solve" not in err.out


# ---------------- the fused level-1 PCG iteration ----------------

def _pcg_problem_host(shape, seed=0):
    """A heat-like batched stencil on boxes [n_dom, lz, ly, lx], float64
    on the host: couplings -U(0.5, 1.5) on the edges whose two ends are
    real, the diagonal their absolute sums plus a mass U(0.1, 1) (so the
    operator is SPD), the last x-plane of every odd domain pad slots
    (identity rows, as the structured path pads)."""
    from geneo4petsc_tpu_torch.structured.grid import _slices

    rng = np.random.default_rng(seed)
    mask = np.ones(shape)
    if shape[-1] > 2:
        mask[1::2, :, :, -1] = 0.0
    diag = rng.uniform(0.1, 1.0, shape)
    offs = []
    for a in range(3):
        lo_s, hi_s = _slices(4, 3 - a)
        c = np.zeros(shape)
        c[lo_s] = -rng.uniform(0.5, 1.5, c[lo_s].shape) * mask[lo_s] \
            * mask[hi_s]
        diag[lo_s] += np.abs(c[lo_s])
        diag[hi_s] += np.abs(c[lo_s])
        offs.append(c)
    return np.where(mask > 0, diag, 1.0), offs, mask


PCG_CASES = {
    # the level-1 boxes of the 10M cells, one system a box
    "heat64-f32": ((64, 58, 58, 58), None, torch.float32, 1e-5),
    # a block of two columns on ragged boxes
    "ragged-f64": ((3, 7, 11, 13), 2, torch.float64, 1e-12),
    # a 2-D box: lz = 1, the z-axis skipped
    "box2d-f32": ((4, 1, 30, 45), None, torch.float32, 1e-5),
}


def _pcg_solver(case, device):
    from geneo4petsc_tpu_torch.structured import local_ops as lo
    from geneo4petsc_tpu_torch.structured import solvers

    shape, m, dtype, _ = PCG_CASES[case]
    diag, offs, mask = _pcg_problem_host(shape)

    def dev(a):
        return torch.from_numpy(a).to(device, dtype)

    st = lo.LocalStencil(diag=dev(diag), offs=tuple(dev(c) for c in offs))
    maskf = dev(mask)
    vshape = shape if m is None else (shape[0], m) + shape[1:]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        vshape)).to(device, dtype)
    pcg = solvers.PCGSolver(st=st, pre=solvers.surrogate_fdm(st, maskf),
                            maskf=maskf, rtol=1e-30, max_it=40)
    return pcg, x


def _fused_iterations(pcg, x, its):
    """(u, r, p) after ``its`` fused iterations, p the last direction."""
    from geneo4petsc_tpu_torch.ops import pcg_fused

    _m, r, _tol2 = pcg._begin(x)
    u = torch.zeros_like(r)
    ws = pcg_fused.Workspace(pcg.st, pcg.maskf, r)
    z = pcg.pre.solve(r)
    for k in range(its):
        if k:
            z = pcg.pre.solve(r)
        ws.dot(r, z)
        p = ws.matvec(z, z if k == 0 else p, first=k == 0)
        ws.update(u, r, p)
    return u, r, p


@pytest.mark.parametrize("its", [1, 2, 5])
@pytest.mark.parametrize("case", list(PCG_CASES))
def test_pcg_fused_iterations_match_plain_step(cuda, case, its):
    """The three kernels of ops/pcg_fused.py against PCGSolver's plain
    start and steps on the same card: u, r and the direction within 1e-5
    relative in float32 (the dots' float32 sums run in another order, and
    alpha and beta carry that into every point) and 1e-12 in float64; one
    launch of each kernel an iteration; the same bits twice."""
    from geneo4petsc_tpu_torch.ops import pcg_fused

    pcg, x = _pcg_solver(case, cuda)
    tol = PCG_CASES[case][3]
    before = (pcg_fused.pcg_matvec.launches, pcg_fused.pcg_update.launches,
              pcg_fused.pcg_dot.launches)
    u, r, p = _fused_iterations(pcg, x, its)
    torch.cuda.synchronize()
    after = (pcg_fused.pcg_matvec.launches, pcg_fused.pcg_update.launches,
             pcg_fused.pcg_dot.launches)
    assert tuple(b + its for b in before) == after
    m, _tol2, state = pcg.start(x)
    for k in range(its):
        if k == its - 1:
            p_want = state[2]
        state = pcg.step(m, state)
    assert _rel(u, state[0]) <= tol
    assert _rel(r, state[1]) <= tol
    assert _rel(p, p_want) <= tol
    again = _fused_iterations(pcg, x, its)
    assert all(torch.equal(a, b) for a, b in zip((u, r, p), again))


def test_pcg_solve_of_a_strided_block_launches_the_kernels(cuda):
    """PCGSolver.solve on a LocalStencil on the card launches each kernel
    once an iteration also for a right-hand side block that is a strided
    view (as a reshaped slice of a LOBPCG block can be), with the bits of
    its contiguous copy."""
    from geneo4petsc_tpu_torch.ops import pcg_fused
    from geneo4petsc_tpu_torch.structured.solvers import PCGSolver

    pcg, x = _pcg_solver("ragged-f64", cuda)
    pcg = dataclasses.replace(pcg, rtol=1e-6)
    strided = x.transpose(-1, -3).contiguous().transpose(-1, -3)
    assert not strided.is_contiguous()
    out = []
    for rhs in (strided, x):
        n0 = [f.launches for f in (pcg_fused.pcg_matvec,
                                   pcg_fused.pcg_update, pcg_fused.pcg_dot)]
        i0 = PCGSolver.iterations
        u = pcg.solve(rhs)
        its = PCGSolver.iterations - i0
        assert its > 0 and [f.launches - n for f, n in zip(
            (pcg_fused.pcg_matvec, pcg_fused.pcg_update, pcg_fused.pcg_dot),
            n0)] == [its] * 3
        out.append((u, its))
    assert out[0][1] == out[1][1] and torch.equal(out[0][0], out[1][0])


def test_pcg_fused_raises_on_a_refused_launch(cuda, monkeypatch):
    """A launch the card refuses (a grid of 70000 blocks in y, over
    CUDA's 65535) comes back as the C entry point's cudaGetLastError and
    raises; at the module's limit the kernel strides over the systems."""
    from geneo4petsc_tpu_torch.ops import pcg_fused

    r = torch.ones((70000, 1, 1, 2), dtype=torch.float32, device=cuda)
    parts = r.new_empty((70000, pcg_fused.plan(r.shape, r.device).n_el))
    with monkeypatch.context() as mp:
        mp.setattr(pcg_fused, "_MAX_GRID_Y", 1 << 20)
        with pytest.raises(RuntimeError, match="CUDA error"):
            pcg_fused.pcg_dot(r, r, parts)
    pcg_fused.pcg_dot(r, r, parts)
    torch.cuda.synchronize()
    assert torch.equal(parts.sum(1), torch.full_like(parts[:, 0], 2.0))


def test_pcg_fused_kernels_link_to_their_host_ops(cuda):
    """Under the profiler each kernel is linked to the host op
    ``pcg_fused.<kernel>`` that its wrapper opens around the launch, as a
    torch op's kernels are to the op (the benchmark's spans read device
    time through that link)."""
    from torch.autograd import DeviceType

    from geneo4petsc_tpu_torch.ops import pcg_fused

    pcg, x = _pcg_solver("box2d-f32", cuda)
    pcg.pre.solve(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _fused_iterations(pcg, x, 2)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ops = {e.correlation_id(): e.name() for e in events
           if e.device_type() == DeviceType.CPU
           and e.linked_correlation_id() == 0}
    linked = {}
    for e in events:
        kernel = re.search(r"pcg_\w+_kernel<\w+>", e.name())
        if e.device_type() == DeviceType.CUDA and kernel:
            linked.setdefault(kernel.group(0), set()).add(
                ops.get(e.linked_correlation_id()))
    assert linked == {
        f"{k}_kernel<float>": {f"pcg_fused.{k}"}
        for k in ("pcg_matvec", "pcg_update", "pcg_dot")}


def _heat16_pc(dtype, device):
    from geneo4petsc_tpu_torch.structured.decompose import \
        StructuredDecomposition
    from geneo4petsc_tpu_torch.structured.geneo import setup_structured
    from geneo4petsc_tpu_torch.structured.grid import heat_grid

    o = GenEOOptions()
    o.lvl1, o.lvl2, o.tau, o.gamma, o.cst, o.optim, o.cut = (
        "SORAS", "H2", 0.1, 10.0, False, 0.0, 4)
    o.els2.type, o.els2.max_it = "lobpcg", 50
    o.dls1.rtol, o.dls1.max_it = 0.05, 40
    g = heat_grid(16, 3, 1e4, "minmax", lbd=1.0, dt=0.1)
    sd = StructuredDecomposition(g, (2, 2, 2), 2)
    pc, _ = setup_structured(sd, o, b=None, dtype=dtype, device=device,
                             bt_budget_bytes=0)
    return g, pc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_pcg_solve_fused_counts_equal_plain_on_heat16(cuda, dtype,
                                                      monkeypatch):
    """PCGSolver.solve on the level-1 of heat 16^3 under SORAS,H2 (the
    heat10m configuration's options, every local solve on the PCG
    route): per apply, the fused path takes the plain path's iterations
    in float64 and within one in float32, and the same counts twice; a
    float64 refined solve takes the same inner and outer counts."""
    from geneo4petsc_tpu_torch.ops import pcg_fused
    from geneo4petsc_tpu_torch.structured import solve as ssolve
    from geneo4petsc_tpu_torch.structured.grid import global_stencil
    from geneo4petsc_tpu_torch.structured.solvers import PCGSolver

    g, pc = _heat16_pc(dtype, cuda)
    l1 = pc.l1
    assert isinstance(l1, PCGSolver)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
          for s in [tuple(l1.maskf.shape)] * 6
          + [(l1.maskf.shape[0], 3) + tuple(l1.maskf.shape[1:])]]

    def counts():
        out = []
        for x in xs:
            i0 = PCGSolver.iterations
            l1.solve(x)
            out.append(PCGSolver.iterations - i0)
        return out

    n0 = pcg_fused.pcg_matvec.launches
    fused = counts()
    assert pcg_fused.pcg_matvec.launches - n0 == sum(fused) > 0
    assert counts() == fused
    b = torch.from_numpy(g.matvec(rng.standard_normal(g.n_nodes))).to(cuda)
    gop64 = global_stencil(g, torch.float64, cuda)

    def refined():
        out = ssolve.refined_solve_device(
            gop64, b, ssolve.make_structured_inner(pc, 2000, "cg"),
            tol=1e-8)
        assert out.converged
        return out.inner_its, out.outer_its

    solve_fused = refined() if dtype == torch.float64 else None
    monkeypatch.setattr(PCGSolver, "_workspace", lambda self, r: (
        pcg_fused.Workspace(self.st, self.maskf, r, axes=3)))
    n0 = pcg_fused.pcg_matvec.launches
    plain = counts()
    assert pcg_fused.pcg_matvec.launches == n0
    if dtype == torch.float64:
        assert fused == plain
        assert refined() == solve_fused
    else:
        assert all(abs(a - b) <= 1 for a, b in zip(fused, plain))
