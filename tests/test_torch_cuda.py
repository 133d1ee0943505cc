"""Tests of the PyTorch port that need a CUDA card; each skips without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)  Tolerances:
the kernels against their plain versions, max relative error 1e-12 in
float64 and 1e-5 in float32 (the sums run in another order); the cpu
and cuda solves, equal iteration counts and solutions within 1e-10."""

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
