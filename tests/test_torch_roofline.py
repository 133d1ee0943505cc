"""The port's roofline accounting (geneo4petsc_tpu_torch/utils/roofline.py)
against the JAX package's (geneo4petsc_tpu/utils/roofline.py), on the
CPU, and the one peaks table and bound rule the measuring tools share.

Both packages solve the JAX package's tests/test_roofline.py case
(laplacian 12^3, kappa 100 minmax, 2x2x2 boxes, overlap 1, ASM,E1, cut
2) once per module.  On the CPU the times mean nothing and neither
package has peaks; what is held is the record's shape (JAX's keys, its
``frac_of_mxu_f32_peak`` renamed ``frac_of_f32_peak``), the budget's
semantics, the analytic byte and operation counts (exact), and the bound
arithmetic behind PERF.md's kernel table (to 1e-4 ms, the table's
rounding)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from geneo4petsc_tpu.config import GenEOOptions as JaxGenEOOptions
from geneo4petsc_tpu.config import KSPOptions as JaxKSPOptions
from geneo4petsc_tpu.structured.grid import laplacian_grid as jax_grid
from geneo4petsc_tpu.structured.solve import solve_structured as jax_solve
from geneo4petsc_tpu.utils import roofline as jax_rl
from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
from geneo4petsc_tpu_torch.structured.blockmode import build_block_mode
from geneo4petsc_tpu_torch.structured.decompose import \
    StructuredDecomposition
from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
from geneo4petsc_tpu_torch.structured.solve import solve_structured
from geneo4petsc_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
GRID = dict(size=12, dim=3, kappa_max=100.0, interp="minmax")
DOMS, OVERLAP = (2, 2, 2), 1
RENAMED = {"frac_of_mxu_f32_peak": "frac_of_f32_peak"}


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX reference compiled with most XLA optimizations off (the
    same programs in about half the time), its programs dropped before
    and after."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
    jax.clear_caches()


@pytest.fixture(scope="module")
def solved():
    """(JAX's output, the port's output) of the same structured solve."""
    jo = JaxGenEOOptions()
    jo.lvl1, jo.lvl2 = "ASM", "E1"
    jo.cut = 2
    jout = jax_solve(jax_grid(**GRID), DOMS, OVERLAP, geneo=jo,
                     ksp=JaxKSPOptions(type="cg"), tol=1e-8)
    to = GenEOOptions()
    to.lvl1, to.lvl2 = "ASM", "E1"
    to.cut = 2
    tout = solve_structured(laplacian_grid(**GRID), DOMS, OVERLAP,
                            geneo=to, ksp=KSPOptions(type="cg"), tol=1e-8,
                            device="cpu")
    assert jout.converged and tout.converged
    return jout, tout


def _keys(rec: dict) -> dict:
    """Each entry's keys, JAX's names mapped to the port's."""
    return {k: {RENAMED.get(kk, kk) for kk in v} if isinstance(v, dict)
            else None for k, v in rec.items()}


def test_record_has_jax_keys(solved):
    jout, tout = solved
    want = jax_rl.measure_structured(jout.pc, reps=2, solve_s=0.5,
                                     inner_its=20)
    got = roofline.measure_structured(tout.pc, reps=2, solve_s=0.5,
                                      inner_its=20)
    assert set(got) == set(want)
    assert got["device_kind"] == "cpu" == want["device_kind"]
    for name, keys in _keys(want).items():
        if keys is not None:
            assert keys <= set(got[name]), name
    for name in ("stencil_matvec", "fdm_apply", "pc_apply"):
        assert got[name]["time_ms"] > 0 and got[name]["achieved_gbps"] > 0


def test_budget_skips_as_jax(solved):
    jout, tout = solved
    want = jax_rl.measure_structured(jout.pc, reps=2, solve_s=0.5,
                                     inner_its=20, budget_s=0.0)
    got = roofline.measure_structured(tout.pc, reps=2, solve_s=0.5,
                                      inner_its=20, budget_s=0.0)
    assert got["skipped"] == want["skipped"] == [
        "stencil_matvec", "fdm_apply", "pc_apply"]
    assert set(got) == set(want)
    for rec in (got, want):
        assert rec["solve_phase"]["inner_its"] == 20
        assert rec["solve_phase"]["solve_s"] == 0.5


def test_stencil_model_equals_jax(solved):
    """JAX's model: 6 float32 arrays of n, 14 flops a node; the port's
    float32 preconditioner gives the same counts."""
    jout, tout = solved
    n = int(np.prod(jout.pc.grid_shape))
    assert tout.pc.x0.dtype == torch.float32
    mv = roofline.measure_structured(tout.pc, reps=2)["stencil_matvec"]
    assert (mv["bytes"], mv["flops"]) == (6 * n * 4, 14 * n)


def test_solve_phase_sums_the_entries(solved):
    _, tout = solved
    pc = tout.pc
    n = int(np.prod(pc.grid_shape))
    rec = roofline.measure_structured(pc, reps=2, solve_s=0.25,
                                      inner_its=7)
    want = (rec["stencil_matvec"]["bytes"] + rec["pc_apply"]["bytes"]
            + 10 * n * pc.x0.element_size())
    agg = rec["solve_phase"]
    assert agg["analytic_gb_per_it"] * 1e9 == pytest.approx(want, rel=1e-15)
    assert agg["achieved_gbps"] == pytest.approx(want * 7 / 1e9 / 0.25)


def test_pencils_and_block_layout(solved):
    """The port's own entries: one LOBPCG step on the setup's tau pencil,
    and the block-layout apply under ``blk``, with the models of the
    module's functions."""
    _, tout = solved
    pc = tout.pc
    sd = StructuredDecomposition(laplacian_grid(**GRID), DOMS, OVERLAP)
    pencils = roofline.tau_pencils(sd, 0.1, 2, torch.float32, "cpu")
    blk = build_block_mode(pc, sd, torch.float32, "cpu")
    rec = roofline.measure_structured(pc, reps=2, pencils=pencils, blk=blk)
    d, n_l, lsq = (int(np.prod(pc.dom_grid)), int(np.prod(pc.local_shape)),
                   int(sum(pc.local_shape)))
    step = rec["lobpcg_step"]
    assert step["k"] == 2 and "lobpcg_step_error" not in rec
    assert (step["bytes"], step["flops"]) == roofline.lobpcg_model(
        2, d * n_l, lsq, 4)
    assert rec["pc_apply"]["model"].startswith("block-layout apply")
    n = int(np.prod(pc.grid_shape))
    assert (rec["pc_apply"]["bytes"], rec["pc_apply"]["flops"]) == \
        roofline.pc_apply_model(pc, n, d * n_l, lsq, 4)


def test_device_peaks(monkeypatch):
    assert roofline.device_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(roofline, "smi_line",
                        lambda index=0: f"{H100}, 700.00 W")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: H100)
    peaks = roofline.device_peaks("cuda")
    assert peaks["kind"] == H100 and peaks["power_limit"] == "700.00 W"
    assert peaks["hbm_bytes_per_s"] == 3.35e12 and peaks["hbm_gbps"] == 3350
    assert peaks["flops"] == {"float32": 67e12, "float64": 34e12,
                              "tf32": 495e12, "bfloat16": 989e12}
    assert roofline.device_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert roofline.device_peaks("cuda") is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel, n_dom, n, dtype, want", [
    ("fused_local_solve", 1024, 496, "float64", 0.6042),
    ("block_matvec", 1024, 496, "float64", 0.6040),
    ("fused_local_solve", 1024, 320, "float32", 0.1261),
    ("block_matvec", 1024, 320, "float32", 0.1260),
])
def test_bound_reproduces_perf_table(kernel, n_dom, n, dtype, want):
    """PERF.md's kernel table (slice and large shapes): chip_smoke.py's
    byte counts through roofline.bound_ms."""
    moved, bound, by = _chip_smoke().kernel_bound(
        kernel, n_dom, n, dtype, False, dict(roofline.PEAKS[H100]))
    assert by == "bytes"
    assert abs(bound - want) < 1e-4
    assert bound == roofline.bound_ms(moved, 2 * n_dom * n * n, dtype,
                                      roofline.PEAKS[H100])[0]


def test_bound_takes_the_larger_term():
    peaks = roofline.PEAKS[H100]
    assert roofline.bound_ms(3.35e9, 0.0, torch.float32, peaks) == \
        (1.0, "bytes")
    assert roofline.bound_ms(0.0, 34e9, torch.float64, peaks) == \
        (1.0, "operations")
    assert roofline.bound_ms(0.0, 495e9, "tf32", peaks) == \
        (1.0, "operations")
