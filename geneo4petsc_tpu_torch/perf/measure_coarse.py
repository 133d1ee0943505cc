"""Measure the replicated coarse solve's wall on the card's machine.

    python -m geneo4petsc_tpu_torch.perf.measure_coarse [--dims
        1024,4096,8192,16384] [--out PATH]

The reference factors E = Z^T A Z with distributed MUMPS
(src/geneo.cpp:1028-1095) because dim(E) grows with the subdomain count.
The port replicates E instead: every rank factors it on the host and
applies the dense factor W (E^-1 = W W^T on the Cholesky path) on its
device.  Replication has a wall: the host factorization is O(dim_e^3)
and W is a dense [dim_e, dim_e] matrix on the card.

For each dim_e this script builds a synthetic SPD E with the real
sparsity (the 27-neighbour domain-grid block structure of
structured/geneo.coarse_e, k = 8 columns a domain; built on the card)
and records

  * ``host_factor_s``: the wall of the port's ``factor_e`` (host LAPACK,
    float64), the set-up cost;
  * ``factor_frac_hbm``: W's bytes in float64 (the generic path's
    dtype) as a share of the card's memory
    (``torch.cuda.get_device_properties(0).total_memory``); float32's are
    half;
  * ``apply_ms_f64`` / ``apply_ms_f32``: one coarse apply
    W (ew^-1 * (W^T w)) (LocalSchwarz.coarse_local's dense part) on the
    card, by CUDA events (the median of 5 readings of 20 calls), beside
    ``roofline.bound_ms`` of W read once and w, ew^-1, the output once.

The wall is the first dim_e where "host_factor_s > 60 s or
factor_frac_hbm > 0.25"; when no measured dim_e breaks the rule, the
largest one measured, with a note saying so.  After the listed dims, the
next doubling runs while the last host factor times 8 stays under 120 s
and the host holds four copies of the larger E.  ``--out`` writes the
record (the package's copy, which precond.geneo.coarse_replication_wall
reads, is geneo4petsc_tpu_torch/perf/coarse_scaling.json); without it
the record is only printed.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np
import torch

from ..precond.geneo import factor_e
from ..utils import roofline
from ..utils.cuda_timing import time_ms

WALL_RULE = "host_factor_s > 60 s or factor_frac_hbm > 0.25"
NEXT_FACTOR_S = 120.0      # run a doubling only while 8x the last fits


def synthetic_e(dim_e: int, k: int = 8, seed: int = 0,
                device="cuda") -> np.ndarray:
    """SPD coarse operator with the domain-grid block sparsity: n_dom =
    dim_e / k domains on a cubic grid, k columns each, coupled to their
    27 neighbours; E = R R^T (the squared sparsity) plus 5% of its mean
    diagonal.  Built in float64 on ``device``, returned on the host."""
    n_dom = dim_e // k
    g = max(int(round(n_dom ** (1 / 3))), 1)
    while g ** 3 < n_dom:
        g += 1
    pos = np.arange(n_dom)
    p = np.stack([pos % g, (pos // g) % g, pos // (g * g)], axis=1)
    near = (np.abs(p[:, None, :] - p[None, :, :]) <= 1).all(axis=2)
    gen = torch.Generator(device=device).manual_seed(seed)
    r = torch.randn((dim_e, dim_e), generator=gen, dtype=torch.float64,
                    device=device) / np.sqrt(dim_e)
    r *= torch.kron(torch.from_numpy(near).to(device, torch.float64),
                    torch.ones((k, k), dtype=torch.float64, device=device))
    e = r @ r.T
    del r
    e.diagonal().add_(float(e.diagonal().mean()) * 0.05 + 1e-6)
    return e.cpu().numpy()


def _apply_ms(w_np: np.ndarray, dtype, peaks: dict) -> tuple:
    """(ms, bound ms, bound by) of one coarse apply in ``dtype``."""
    w = torch.from_numpy(w_np).to("cuda", dtype)
    dim_e = w.shape[0]
    ew_inv = torch.ones(dim_e, dtype=dtype, device="cuda")
    v = torch.randn(dim_e, dtype=dtype, device="cuda")

    def apply():
        return w @ (ew_inv * (w.T @ v))

    apply()
    torch.cuda.synchronize()
    ms = statistics.median(time_ms(apply, 20) for _ in range(5))
    isz = w.element_size()
    bound, by = roofline.bound_ms((dim_e * dim_e + 3 * dim_e) * isz,
                                  4 * dim_e * dim_e, dtype, peaks)
    del w
    torch.cuda.empty_cache()
    return ms, bound, by


def measure(dim_e: int, peaks: dict, mem_bytes: int) -> dict:
    e = synthetic_e(dim_e)
    t0 = time.perf_counter()
    w, ew, e_null = factor_e(e, np.float64, e_dtype=np.float64)
    t_factor = time.perf_counter() - t0
    if e_null or not np.all(ew == 1.0):
        raise RuntimeError(f"dim_e {dim_e}: the synthetic E did not take "
                           "the Cholesky path")
    del e
    f64_bytes = dim_e * dim_e * 8
    ms64, b64, by64 = _apply_ms(w, torch.float64, peaks)
    ms32, b32, by32 = _apply_ms(w, torch.float32, peaks)
    return {"dim_e": dim_e, "host_factor_s": t_factor,
            "factor_mb_f64": f64_bytes / 1e6,
            "factor_mb_f32": f64_bytes / 2e6,
            "factor_frac_hbm": f64_bytes / mem_bytes,
            "apply_ms_f64": ms64, "apply_bound_ms_f64": b64,
            "apply_bound_by_f64": by64,
            "apply_ms_f32": ms32, "apply_bound_ms_f32": b32,
            "apply_bound_by_f32": by32}


def _host() -> dict:
    """The host's CPU as /proc/cpuinfo names it (its first processor),
    torch's vector ISA, the threads this process may use, the memory."""
    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                key = key.strip()
                if key in ("vendor_id", "model name", "cpu family",
                           "model") and key not in cpu:
                    cpu[key] = val.strip()
    except OSError:
        pass
    return {"cpu_model": cpu.get("model name") or platform.processor(),
            "cpuinfo": cpu, "isa": torch.backends.cpu.get_cpu_capability(),
            "threads": len(os.sched_getaffinity(0)),
            "memory_bytes": os.sysconf("SC_PAGE_SIZE")
            * os.sysconf("SC_PHYS_PAGES")}


def wall_of(rows: list) -> tuple[int, str | None]:
    """The first dim_e that breaks WALL_RULE, else the largest measured
    with a note."""
    for r in rows:
        if r["host_factor_s"] > 60.0 or r["factor_frac_hbm"] > 0.25:
            return r["dim_e"], None
    return rows[-1]["dim_e"], ("no measured dim_e broke the rule: the wall "
                               "is the largest dim_e measured")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", default="1024,4096,8192,16384")
    ap.add_argument("--out", metavar="PATH")
    args = ap.parse_args(argv)
    peaks = roofline.device_peaks("cuda")
    if peaks is None:
        print("measure_coarse: needs a CUDA card the peaks table knows",
              file=sys.stderr)
        return 1
    print(roofline.smi_line(), flush=True)
    mem = torch.cuda.get_device_properties(0).total_memory
    host = _host()
    dims = [int(d) for d in args.dims.split(",")]
    rows = []
    while dims:
        rows.append(measure(dims.pop(0), peaks, mem))
        print(json.dumps(rows[-1]), flush=True)
        nxt = 2 * rows[-1]["dim_e"]
        if (not dims and rows[-1]["host_factor_s"] * 8 < NEXT_FACTOR_S
                and 4 * nxt * nxt * 8 < host["memory_bytes"]):
            dims.append(nxt)
    wall, note = wall_of(rows)
    rec = {"card": peaks["kind"], "power_limit": peaks["power_limit"],
           "card_memory_bytes": mem, "host": host, "rows": rows,
           "replication_wall_dim_e": wall, "wall_rule": WALL_RULE,
           "torch": torch.__version__,
           "reproduce": "python -m geneo4petsc_tpu_torch.perf."
                        "measure_coarse --out geneo4petsc_tpu_torch/perf/"
                        "coarse_scaling.json"}
    if note:
        rec["note"] = note
    print(json.dumps({"replication_wall_dim_e": wall, "note": note}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
