"""How much the LOBPCG start block moves the structured case's result.

    python -m geneo4petsc_tpu_torch.perf.lobpcg_start [--size 216]
        [--doms 4] [--seeds 0,1,2,3] [--device cuda]

Solves the repository's structured case (laplacian --size 216 --dim 3
--kappa 10000. minmax: 10,077,696 DOF; 4x4x4 boxes, overlap 2; ASM,E1
with LOBPCG cut 2, 50 iterations; float32 CG inside float64 refinement
to 1e-8) once per start block of the GenEO eigensolve:

* the port's own draw, a torch.Generator seeded with each of ``--seeds``;
* the JAX package's draw, jax.random.normal(PRNGKey(0), ...), rebuilt
  here without JAX (``jax_normal32``);
* the JAX draw and the torch seed-0 draw again with the Rayleigh-Ritz
  and whitening eigendecompositions in float32 instead of float64 (the
  JAX package runs them in float32 on a TPU, in float64 on the CPU).

Each run prints its coarse dimension (and how many boxes kept 0, 1 or
2 eigenvectors: a box keeps a pair only when LOBPCG converged it), the
largest kept LOBPCG residual, the inner and outer iteration counts and
the true residual.  ``--device cpu --size 24 --doms 2`` rehearses it
here at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import GenEOOptions, KSPOptions
from ..ops import lobpcg
from ..ops.lobpcg import default_start
from ..structured.grid import laplacian_grid
from ..structured.solve import solve_structured

_M32 = 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k0, k1); uint32 values held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


# Giles' single-precision erfinv polynomials, as XLA evaluates erf_inv
# in float32 (for w = -log1p(-x^2) below 5, and from 5 up)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of float32 x by XLA's float32 formula, in float32."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_W_LT_5[0]),
                    torch.tensor(_ERFINV_W_GE_5[0])).to(x.device)
    for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(lt, torch.tensor(c_lt, device=x.device),
                        torch.tensor(c_ge, device=x.device)) + p * w
    return p * x


def jax_normal32(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32),
    rebuilt with torch: the partitionable Threefry bits (JAX's default)
    and the uniform they map to are exact, and the inverse error
    function follows XLA's float32 formula, so the draw agrees with
    JAX's on the CPU to 2 units in the last place."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(0, 0, idx >> 32, idx & _M32)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    # u * (1 - lo) + lo on [lo, 1), lo = nextafter(-1, 0); 1 - lo rounds
    # to 2 in float32, as in JAX
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)),
                      device=device)
    u = torch.maximum(lo, u * 2.0 + lo)
    return (torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
            * _erfinv32(u)).reshape(shape)


def jax_normal64(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64),
    rebuilt with torch: the partitionable Threefry pair gives the 64 bits
    (b1 << 32 | b2) and the uniform they map to exactly; the inverse
    error function is torch's float64 one, so the draw agrees with
    JAX's to 1e-14 relative (the tails, where the two erfinv part)."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(0, 0, idx >> 32, idx & _M32)
    # the top 52 of the 64 bits as the mantissa of a float in [1, 2)
    mant = ((b1 << 20) | (b2 >> 12)) & ((1 << 52) - 1)
    u = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = torch.tensor(np.nextafter(-1.0, 0.0), dtype=torch.float64,
                      device=device)
    u = torch.maximum(lo, u * (1.0 - lo) + lo)
    return (np.sqrt(2.0) * torch.special.erfinv(u)).reshape(shape)


def jax_start(d: int, n: int, k: int, dtype, device="cpu") -> torch.Tensor:
    """The JAX package's LOBPCG start block (structured/geneo.py and
    structured/elastic.py draw jax.random.normal(PRNGKey(0), (d, n,
    k))), in float32 or float64."""
    if dtype == torch.float32:
        return jax_normal32((d, n, k), device)
    if dtype == torch.float64:
        return jax_normal64((d, n, k), device)
    raise ValueError(f"jax_start: no draw for {dtype}")


class _Float32Eigh:
    """torch.linalg with eigh computed in float32 (results cast back)."""

    @staticmethod
    def eigh(a):
        e, v = torch.linalg.eigh(a.float())
        return e.to(a.dtype), v.to(a.dtype)

    def __getattr__(self, name):
        return getattr(torch.linalg, name)


class _TorchFloat32Eigh:
    linalg = _Float32Eigh()

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def float32_gram_eigh():
    """Run the LOBPCG's small eigendecompositions in float32."""
    lobpcg.torch = _TorchFloat32Eigh()
    try:
        yield
    finally:
        lobpcg.torch = torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=216)
    ap.add_argument("--doms", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("lobpcg_start: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False

    grid = laplacian_grid(args.size, dim=3, kappa_max=10000.0,
                          interp="minmax")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    runs = [(f"torch seed {s}", functools.partial(default_start, seed=s),
             False) for s in seeds]
    jax_dev = functools.partial(jax_start, device=dev)
    runs += [("jax PRNGKey(0)", jax_dev, False),
             ("jax PRNGKey(0), float32 eigh", jax_dev, True),
             (f"torch seed {seeds[0] if seeds else 0}, float32 eigh",
              functools.partial(default_start,
                                seed=seeds[0] if seeds else 0), True)]
    print(f"[case] {grid.n_nodes} DOF, {args.doms}^3 boxes, overlap "
          f"{args.overlap}, ASM,E1, LOBPCG cut 2 max_it 50, float32 CG, "
          f"tol 1e-8, device {dev}", flush=True)
    for label, start, f32_eigh in runs:
        opts = GenEOOptions()
        opts.lvl1, opts.lvl2 = "ASM", "E1"
        opts.els2.type, opts.els2.max_it, opts.cut = "lobpcg", 50, 2
        t0 = time.perf_counter()
        with float32_gram_eigh() if f32_eigh else contextlib.nullcontext():
            out = solve_structured(grid, (args.doms,) * 3, args.overlap,
                                   geneo=opts, ksp=KSPOptions(type="cg"),
                                   tol=1e-8, dtype=torch.float32,
                                   device=dev, lobpcg_start=start)
        wall = time.perf_counter() - t0
        st = out.stats
        kept = np.bincount(np.asarray(st.real_dim_e, np.int64),
                           minlength=3)
        res = np.asarray(st.lobpcg_res if st.lobpcg_res is not None
                         else [np.nan], np.float64)
        print(f"[start] {label}: dim_e {int(st.real_dim_e.sum())} (boxes "
              f"keeping 0/1/2: {'/'.join(str(int(c)) for c in kept[:3])}),"
              f" kept LOBPCG residual max {res.max():.3e} median "
              f"{np.median(res):.3e}; {out.refined.inner_its} inner / "
              f"{out.refined.outer_its} outer, true_res {out.true_res:.3e},"
              f" converged {out.converged}; setup "
              f"{out.timers.phases.get('setup', float('nan')):.2f} s, "
              f"solve {out.timers.phases.get('solve', float('nan')):.2f} s,"
              f" wall {wall:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
