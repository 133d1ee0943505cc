"""How much the LOBPCG start block moves the structured case's result.

    python -m geneo4petsc_tpu_torch.perf.lobpcg_start [--size 216]
        [--doms 4] [--seeds 0,1,2,3] [--device cuda]

Solves the repository's structured case (laplacian --size 216 --dim 3
--kappa 10000. minmax: 10,077,696 DOF; 4x4x4 boxes, overlap 2; ASM,E1
with LOBPCG cut 2, 50 iterations; float32 CG inside float64 refinement
to 1e-8) once per start block of the GenEO eigensolve:

* the port's own draw, a torch.Generator seeded with each of ``--seeds``;
* the JAX package's draw, jax.random.normal(PRNGKey(0), ...), rebuilt
  without JAX (``ops.start_draw.jax_start``; the structured path's
  default start since it is drawn on the card);
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
from ..ops.start_draw import jax_start
from ..structured.grid import laplacian_grid
from ..structured.solve import solve_structured


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
