"""Drive the PyTorch port (geneo4petsc_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line or block of output each; any failure ends the script
with a non-zero exit code and no result line:

1. device   — the card's name and power limit (nvidia-smi); TF32 off.
2. build    — compile the CUDA kernels of geneo4petsc_tpu_torch/csrc/
              (nvcc, sm_90a) and the native partitioner (native/kway.cpp).
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the slice's shape [1024, 496, 496] float64 and at shapes
              that reach both of its paths (the bulk-copy ring and the
              direct loads) and their edges: odd n, n no multiple of 32,
              fewer domains than SMs, a domain count no multiple of the
              grid, a large n, float32 with n % 4 of 0 and 2, and a batch
              whose base pointer is 8- but not 16-byte aligned; max
              relative error <= 1e-12 (float64) / 1e-5 (float32), and
              repeated launches give the same bits.  At the slice's shape
              the kernel and torch.bmm (the library call for the same
              product, which the port never calls on the card) are timed
              in turns by CUDA events, with the bound from the bytes.
4. small    — the same small GenEO solve through the CLI on cpu and on
              cuda: equal iteration counts and reasons.
5. slice    — the generic GenEO path at 262,144 DOF through the CLI
              (laplacian --size 512 --dim 2 --kappa 10000. minmax, 1024
              subdomains, overlap 1, ASM,E1, inverse_pallas, CG 1e-8);
              checks convergence, dim_e, Nicolaides count, iterations
              and that the main path launched both kernels.
6. structured-parity — the structured path (solve_structured) in float64
              on laplacian 24^3, kappa 1e4 minmax, 2x2x2 boxes, overlap 2,
              ASM,E1, LOBPCG cut 2, CG 1e-8, by both refinement routes:
              per-domain dim_e and Nicolaides, outer passes and inner
              iterations (+-1) equal to the JAX package's on the CPU,
              true residual <= 1e-8.
7. structured — the structured path through the CLI at the repository's
              10,077,696-DOF case (laplacian --size 216 --dim 3 --kappa
              10000. minmax, --structured 4,4,4, overlap 2, ASM,E1, LOBPCG
              cut 2 max_it 50, float32 CG inside float64 refinement to
              1e-8): converged, true residual <= 1e-8 (and again on the
              host), max error against x = 1..n, dim_e, iterations, TIME
              lines and peak device memory, beside the JAX package's TPU
              record as a reference.  K1 and K2 are not on this path:
              their counts, zeroed before it, stay 0.

It then prints one JSON line with every kernel's launches, error, path,
times and bound, and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE_ARGS = ["--inpLibA", "laplacian",
              "--inpLibArg", "--size#512#--dim#2#--kappa#10000.#minmax",
              "--nbPart", "1024", "--addOverlap", "1", "--metisDual",
              "-pc_type", "geneo", "-geneo_lvl", "ASM,E1",
              "-dls1_type", "inverse_pallas", "-ksp_type", "cg",
              "-ksp_rtol", "1e-8"]
SLICE_DOF, SLICE_DIM_E, SLICE_NICOLAIDES, SLICE_ITS = 262144, 2776, 1, 58
SMALL_ARGS = ["--inpLibA", "laplacian", "--inpLibArg", "--size#32#--dim#2",
              "--nbPart", "8", "--addOverlap", "1", "-pc_type", "geneo",
              "-geneo_lvl", "ASM,E1", "-dls1_type", "inverse_pallas",
              "-ksp_type", "cg", "-ksp_rtol", "1e-8"]
MAIN_SHAPE = (1024, 496)   # (n_dom, n_max) of the slice
TOL = {"float64": 1e-12, "float32": 1e-5}
# (n_dom, n), dtype, base pointer 16-byte aligned, the path it must take
KERNEL_CASES = [
    (MAIN_SHAPE, "float64", True, "ring"),
    ((3, 37), "float64", True, "direct"),       # odd n
    ((3, 37), "float32", True, "direct"),
    ((7, 50), "float64", True, "ring"),         # n % 32 != 0, few domains
    ((5, 66), "float32", True, "direct"),       # n % 4 == 2
    ((5, 64), "float32", True, "ring"),         # n % 4 == 0
    ((133, 496), "float64", True, "ring"),      # n_dom % grid != 0
    ((2, 3000), "float64", True, "ring"),       # large n
    ((7, 50), "float64", False, "direct"),      # misaligned base pointer
    (MAIN_SHAPE, "float64", False, "direct"),
]
# Published peaks of the H100 SXM (NVIDIA's data sheet): device memory
# rate, and float64 / float32 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

# structured-parity: the JAX package's values on the CPU (float64), from
#   python -c "import jax; jax.config.update('jax_enable_x64', True)
#   import jax.numpy as jnp
#   from geneo4petsc_tpu.config import GenEOOptions, KSPOptions
#   from geneo4petsc_tpu.structured.grid import laplacian_grid
#   from geneo4petsc_tpu.structured.solve import solve_structured
#   g = GenEOOptions(); g.lvl1, g.lvl2 = 'ASM', 'E1'
#   g.els2.type, g.els2.max_it, g.cut = 'lobpcg', 50, 2
#   for dr in (False, True):
#       o = solve_structured(laplacian_grid(24, dim=3, kappa_max=1e4,
#           interp='minmax'), (2, 2, 2), 2, geneo=g,
#           ksp=KSPOptions(type='cg'), tol=1e-8, dtype=jnp.float64,
#           device_refine=dr)
#       print(o.refined.outer_its, o.refined.inner_its,
#             list(o.stats.real_dim_e), list(o.stats.nicolaides), o.true_res)"
# run from the repository root with JAX on the CPU.
PARITY_GRID = dict(size=24, dim=3, kappa_max=1e4, interp="minmax")
PARITY_DOMS, PARITY_OVERLAP = (2, 2, 2), 2
PARITY_DIM_E, PARITY_NICOLAIDES = [1] * 8, [0] * 8
PARITY_JAX = {"host": {"outer": 2, "inner": 34, "true_res": 7.387e-11},
              "device": {"outer": 2, "inner": 29, "true_res": 2.357e-10}}
STRUCTURED_ARGS = ["--structured", "4,4,4", "--inpLibA", "laplacian",
                   "--inpLibArg", "--size#216#--dim#3#--kappa#10000.#minmax",
                   "--addOverlap", "2", "-pc_type", "geneo",
                   "-geneo_lvl", "ASM,E1", "-els2_type", "lobpcg",
                   "-els2_eps_max_it", "50", "-geneo_cut", "2",
                   "-ksp_type", "cg", "-ksp_rtol", "1e-8", "--timing"]
STRUCTURED_DOF = 10077696
# the JAX package's record of this case on a TPU v5e (BENCH_r05.json):
# a reference point, not a target
JAX_TPU_RECORD = "dim_e 113, 140 inner / 3 outer iterations, true_res 1.33e-9"

_RE_SOLVE = re.compile(r"INFO: solve - (converged|diverged) \(([A-Z_]+)\), "
                       r"(\d+) iteration\(s\), residual norm \S+, "
                       r"\|\| AX - B \|\| / \|\| B \|\| (\S+)")
_RE_DOF = re.compile(r"INFO: nb DOFs (\d+),")
_RE_DIME = re.compile(r"real dimE (\d+) .*nicolaides (\d+)")
_RE_REFINED = re.compile(r"INFO: solve - (converged|diverged) \(refined, "
                         r"(\d+) outer\), (\d+) iteration\(s\), "
                         r"\|\| AX - B \|\| / \|\| B \|\| (\S+)")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase_device() -> str:
    import torch

    check(torch.cuda.is_available(), "no CUDA device (torch.cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build() -> None:
    from geneo4petsc_tpu_torch.ops import _build
    from geneo4petsc_tpu_torch.partition import native

    t0 = time.perf_counter()
    path, report = _build.build(ptxas_info=True)
    t_cuda = time.perf_counter() - t0
    _build.load()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", report))
    print(f"[build] ptxas: {len(regs)} kernels, at most {max(regs)} "
          f"registers a thread, {spills} bytes of spills", flush=True)
    t0 = time.perf_counter()
    native.build()
    t_native = time.perf_counter() - t0
    check(native.available(), "native partitioner did not load")
    print(f"[build] kernels {os.path.relpath(path, HERE)} in {t_cuda:.2f} s,"
          f" native partitioner in {t_native:.2f} s", flush=True)


def _kernel_inputs(n_dom, n, dtype, aligned, rng, dev):
    """Seeded inputs of one case.  A misaligned case puts the matrix
    batch one element into a longer buffer: contiguous, but its base
    pointer is no multiple of 16 bytes."""
    import torch

    inv = torch.from_numpy(rng.standard_normal((n_dom, n, n))).to(dev, dtype)
    if not aligned:
        buf = torch.empty(inv.numel() + 1, dtype=dtype, device=dev)
        buf[1:].copy_(inv.flatten())
        inv = buf[1:].view(n_dom, n, n)
        check(inv.data_ptr() % 16 != 0 and inv.is_contiguous(),
              "the misaligned case is aligned")
    d = torch.from_numpy(rng.random((n_dom, n)) + 0.5).to(dev, dtype)
    mask = torch.from_numpy(rng.random((n_dom, n)) > 0.2).to(dev)
    x = torch.from_numpy(rng.standard_normal((n_dom, n))).to(dev, dtype)
    return inv, d, mask, x


def phase_kernels() -> dict:
    """Each kernel against its plain version at every case; returns the
    main-shape numbers per kernel for the JSON line."""
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.utils.cuda_timing import time_in_turns

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    summary = {}
    for (n_dom, n), dtype_name, aligned, want_path in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        inv, d, mask, x = _kernel_inputs(n_dom, n, dtype, aligned, rng, dev)
        tol = TOL[dtype_name]
        where = (f"[{n_dom},{n},{n}] {dtype_name}"
                 f"{'' if aligned else ' misaligned'}")
        path = lk.plan_for(inv).path
        check(path == want_path, f"{where} took the {path} path, "
                                 f"expected {want_path}")

        def lib():
            return torch.bmm(inv, x.unsqueeze(-1))

        runs = [("fused_local_solve", f"pre={pre} post={post}",
                 lambda pre=pre, post=post: lk.fused_local_solve(
                     inv, d, mask, x, pre, post),
                 lambda pre=pre, post=post: lk.fused_local_solve_plain(
                     inv, d, mask, x, pre, post),
                 mask.numel() + (pre or post) * d.numel() * d.element_size())
                for pre, post in ((False, False), (True, False), (True, True))]
        runs.append(("block_matvec", "", lambda: lk.block_matvec(inv, x),
                     lambda: lk.block_matvec_plain(inv, x), 0))
        for name, variant, kern, plain, vector_bytes in runs:
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            abs_err = float((got - want).abs().max())
            rel_err = abs_err / max(float(want.abs().max()), 1e-300)
            line = (f"[kernels] {name} {variant} {where} {path}: max rel "
                    f"err {rel_err:.3e} (tol {tol:g})")
            check(rel_err <= tol, f"{name} {variant} {where} disagrees with "
                                  f"its plain version: {rel_err:.3e} > {tol:g}")
            check(torch.equal(got, again), f"{name} {variant} {where}: two "
                                           "launches gave different bits")
            if (n_dom, n) != MAIN_SHAPE:
                print(line, flush=True)
                continue
            # every input read once, the output written once
            moved = ((inv.numel() + 2 * x.numel()) * inv.element_size()
                     + vector_bytes)
            by_bytes = moved / PEAK_BYTES_PER_S * 1e3
            by_ops = 2 * inv.numel() / PEAK_FLOPS[dtype_name] * 1e3
            bound_ms = max(by_bytes, by_ops)
            # in turns: library, kernel, kernel, library
            b, k = time_in_turns(lib, kern)
            _, p = time_in_turns(lib, plain, rounds=3)
            share = bound_ms / k["ms"]
            print(f"{line}; kernel {k['ms']:.4f} ms [{k['min_ms']:.4f}, "
                  f"{k['max_ms']:.4f}], torch.bmm {b['ms']:.4f} ms "
                  f"[{b['min_ms']:.4f}, {b['max_ms']:.4f}], plain "
                  f"{p['ms']:.4f} ms, bound {bound_ms:.4f} ms ({moved} B), "
                  f"share of bound {share:.3f}", flush=True)
            check(share <= 1.0, f"{name} {where}: {k['ms']:.4f} ms is under "
                                f"the bound {bound_ms:.4f} ms")
            if aligned:
                # the slice runs ASM: K1 without weights is its variant
                row = summary.setdefault(name, {"max_abs_err": 0.0})
                row["max_abs_err"] = max(row["max_abs_err"], abs_err)
                if variant in ("", "pre=False post=False"):
                    row.update(
                        path=path, ms=k["ms"], ms_min=k["min_ms"],
                        ms_max=k["max_ms"], library_ms=b["ms"],
                        plain_ms=p["ms"], bound_ms=bound_ms,
                        bound_by="bytes" if by_bytes >= by_ops
                        else "operations", share_of_bound=share)
        del inv, d, mask, x
        torch.cuda.empty_cache()
    return summary


def _run_cli(args: list[str]) -> tuple[str, dict]:
    from geneo4petsc_tpu_torch import cli

    buf = io.StringIO()
    rc = cli.run(args, out=buf)
    log = buf.getvalue()
    check(rc == 0, f"CLI exited {rc}:\n{log}")
    m = _RE_SOLVE.search(log)
    check(m is not None, f"no solve line in the CLI output:\n{log}")
    info = {"status": m.group(1), "reason": m.group(2),
            "its": int(m.group(3)), "true_res": float(m.group(4))}
    md = _RE_DOF.search(log)
    info["n_dof"] = int(md.group(1)) if md else None
    me = _RE_DIME.search(log)
    if me:
        info["dim_e"], info["nicolaides"] = int(me.group(1)), int(me.group(2))
    return log, info


def phase_small() -> None:
    _, on_cpu = _run_cli(SMALL_ARGS + ["--device", "cpu"])
    _, on_cuda = _run_cli(SMALL_ARGS + ["--device", "cuda"])
    print(f"[small] laplacian 32x32, 8 domains: cpu {on_cpu['its']} its "
          f"{on_cpu['reason']} true_res {on_cpu['true_res']:g}; cuda "
          f"{on_cuda['its']} its {on_cuda['reason']} true_res "
          f"{on_cuda['true_res']:g}", flush=True)
    check(on_cpu["status"] == "converged", "small case did not converge")
    check((on_cpu["its"], on_cpu["reason"])
          == (on_cuda["its"], on_cuda["reason"]),
          "small case: cpu and cuda disagree on iterations or reason")


def phase_slice() -> dict:
    import torch

    from geneo4petsc_tpu_torch.ops import local_kernels as lk

    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    t0 = time.perf_counter()
    log, info = _run_cli(SLICE_ARGS + ["--device", "cuda", "--timing"])
    wall = time.perf_counter() - t0
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in log.splitlines():
        if line.startswith(("INFO", "WRNG", "TIME", "      ")):
            print(f"[slice] {line}", flush=True)
    print(f"[slice] wall {wall:.2f} s, peak device memory {peak_gb:.2f} GB, "
          f"launches {launches}", flush=True)
    its = info["its"]
    check(info["reason"] == "KSP_CONVERGED_RTOL",
          f"slice did not converge: {info['reason']}")
    check(info["n_dof"] == SLICE_DOF, f"slice DOFs {info['n_dof']}")
    check(info.get("dim_e") == SLICE_DIM_E, f"slice dim_e {info.get('dim_e')}")
    check(info.get("nicolaides") == SLICE_NICOLAIDES,
          f"slice nicolaides {info.get('nicolaides')}")
    check(abs(its - SLICE_ITS) <= 1, f"slice iterations {its}")
    check(info["true_res"] <= 1e-9, f"slice true residual {info['true_res']}")
    # the wrappers launch a kernel only for CUDA tensors, so these counts
    # also show that the solve's vectors lived on the card
    check(launches["fused_local_solve"] >= its,
          f"K1 launched {launches['fused_local_solve']} < {its} times")
    check(launches["block_matvec"] >= 2 * its,
          f"K2 launched {launches['block_matvec']} < {2 * its} times")
    check(peak_gb >= 4.0, f"peak device memory {peak_gb:.2f} GB: the "
                          "operator blocks did not live on the card")
    return launches


def phase_structured_parity() -> None:
    import torch

    from geneo4petsc_tpu_torch.config import GenEOOptions, KSPOptions
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
    from geneo4petsc_tpu_torch.structured.solve import solve_structured

    for route, device_refine in (("host", False), ("device", True)):
        g = GenEOOptions()
        g.lvl1, g.lvl2 = "ASM", "E1"
        g.els2.type, g.els2.max_it, g.cut = "lobpcg", 50, 2
        t0 = time.perf_counter()
        out = solve_structured(laplacian_grid(**PARITY_GRID), PARITY_DOMS,
                               PARITY_OVERLAP, geneo=g,
                               ksp=KSPOptions(type="cg"), tol=1e-8,
                               dtype=torch.float64, device="cuda",
                               device_refine=device_refine)
        wall = time.perf_counter() - t0
        want = PARITY_JAX[route]
        dim_e = [int(v) for v in out.stats.real_dim_e]
        nic = [int(v) for v in out.stats.nicolaides]
        print(f"[structured-parity] {route} refinement: {out.refined.outer_its}"
              f" outer / {out.refined.inner_its} inner (JAX on the CPU: "
              f"{want['outer']} / {want['inner']}), dim_e {dim_e}, "
              f"nicolaides {sum(nic)}, true_res {out.true_res:.3e} (JAX "
              f"{want['true_res']:.3e}), {wall:.2f} s", flush=True)
        check(out.pc.z.device.type == "cuda", "the coarse basis is not on "
                                              "the card")
        check(dim_e == PARITY_DIM_E, f"structured-parity dim_e {dim_e}")
        check(nic == PARITY_NICOLAIDES, f"structured-parity nicolaides {nic}")
        check(out.refined.outer_its == want["outer"],
              f"structured-parity outer passes {out.refined.outer_its}")
        check(abs(out.refined.inner_its - want["inner"]) <= 1,
              f"structured-parity inner iterations {out.refined.inner_its}")
        check(out.converged and out.true_res <= 1e-8,
              f"structured-parity true residual {out.true_res}")


def phase_structured() -> dict:
    import torch

    from geneo4petsc_tpu_torch import cli
    from geneo4petsc_tpu_torch.ops import local_kernels as lk
    from geneo4petsc_tpu_torch.structured import solve as ssolve
    from geneo4petsc_tpu_torch.structured.grid import laplacian_grid

    # keep the CLI's solve output, for the error against x = 1..n
    seen = {}
    solve = ssolve.solve_structured

    def keep(*args, **kw):
        seen["out"] = solve(*args, **kw)
        return seen["out"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lk.fused_local_solve.launches = 0
    lk.block_matvec.launches = 0
    ssolve.solve_structured = keep
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        rc = cli.run(STRUCTURED_ARGS + ["--device", "cuda"], out=buf)
    finally:
        ssolve.solve_structured = solve
    wall = time.perf_counter() - t0
    launches = {"fused_local_solve": lk.fused_local_solve.launches,
                "block_matvec": lk.block_matvec.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = buf.getvalue()
    for line in log.splitlines():
        if line.startswith(("INFO", "WRNG", "TIME", "      ")):
            print(f"[structured] {line}", flush=True)
    check(rc == 0, f"structured CLI exited {rc}:\n{log}")
    m = _RE_REFINED.search(log)
    check(m is not None, f"no solve line in the structured output:\n{log}")
    md, me = _RE_DOF.search(log), _RE_DIME.search(log)
    out = seen["out"]
    n = STRUCTURED_DOF
    x = np.asarray(out.x, np.float64)
    err = float(np.max(np.abs(x - np.arange(1.0, n + 1)))) / n
    t0 = time.perf_counter()
    grid = laplacian_grid(216, dim=3, kappa_max=10000.0, interp="minmax")
    host_res = float(np.linalg.norm(out.b - grid.matvec(x))
                     / np.linalg.norm(out.b))
    t_host = time.perf_counter() - t0
    info = {"dim_e": int(me.group(1)), "nicolaides": int(me.group(2)),
            "outer": int(m.group(2)), "inner": int(m.group(3)),
            "true_res": float(m.group(4)), "wall_s": wall,
            "peak_gb": peak_gb}
    print(f"[structured] {n} DOF on the card: {info['inner']} inner / "
          f"{info['outer']} outer iterations, dim_e {info['dim_e']}, "
          f"true_res {out.true_res:.3e} (host float64 recheck "
          f"{host_res:.3e} in {t_host:.1f} s), max |x - x_true| / n "
          f"{err:.3e}; CLI wall {wall:.2f} s, peak device memory "
          f"{peak_gb:.2f} GB; K1/K2 launches on this path {launches}",
          flush=True)
    print(f"[structured] reference, not a target — the JAX package on a "
          f"TPU v5e (BENCH_r05.json): {JAX_TPU_RECORD}", flush=True)
    check(md is not None and int(md.group(1)) == n,
          f"structured DOFs {md and md.group(1)}")
    check(m.group(1) == "converged", "the structured case did not converge")
    check(out.true_res <= 1e-8 and host_res <= 1e-8,
          f"structured true residual {out.true_res} / host {host_res}")
    check(bool(np.isfinite(x).all()), "non-finite solution")
    check(out.pc.z is not None and out.pc.z.device.type == "cuda",
          "the preconditioner did not live on the card")
    check(launches == {"fused_local_solve": 0, "block_matvec": 0},
          f"K1/K2 launched on the structured path: {launches}")
    check(peak_gb >= 1.0, f"peak device memory {peak_gb:.2f} GB: the "
                          "structured operators did not live on the card")
    return info


def main() -> int:
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    try:
        import geneo4petsc_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: geneo4petsc_tpu_torch not found next to this "
              "script; run it from the repository root", file=sys.stderr)
        return 1

    phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_small()
    launches = phase_slice()
    phase_structured_parity()
    phase_structured()

    sources = {"fused_local_solve": ("geneo4petsc_tpu_torch/csrc/"
                                     "fused_local_solve.cu",
                                     "geneo4petsc_tpu/ops/pallas_kernels.py:90"),
               "block_matvec": ("geneo4petsc_tpu_torch/csrc/block_matvec.cu",
                                "geneo4petsc_tpu/ops/pallas_kernels.py:125")}
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], **kernels[name]}
            for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
