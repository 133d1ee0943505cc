"""One run of one cell: set-up, the measured window, the traced ops, the
check against the plain reference, and the result line.

``main`` is the command line (``run.py``); ``run_cell`` is the run, with
the device and, for the tests, a configuration of another size.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch

from . import tracing
from .spec import BENCH_DIR, Spec
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "geneo4petsc_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


class NoResult(Exception):
    """The run prints no result line and exits with ``code``."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


@dataclass
class Reading:
    """What the metric readers read (``metrics/<name>.py``)."""

    config: dict
    n_dof: int
    setup_s: float
    window_s: float                   # window start to the last op's end
    ops: list              # per op: wall_s, device_s, inner, outer, timers
    counters: dict                    # program counters over the window
    memory_peak_bytes: int
    device_kind: str
    roofline: object                  # reference/roofline.py
    trace: tracing.TraceSummary | None = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """An op's time on the host's clock and, on a card, between two
    CUDA events around it (the device's clock)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        _sync(self.device)
        self.t0 = time.perf_counter()
        if self.cuda:
            self.e0.record()

    def stop(self) -> tuple[float, float]:
        """(host seconds, device seconds)."""
        if self.cuda:
            self.e1.record()
        _sync(self.device)
        wall = time.perf_counter() - self.t0
        dev = self.e0.elapsed_time(self.e1) / 1e3 if self.cuda else wall
        return wall, dev


# solve indices: the warm-up op's, the window's from 1, the traced ops'
WARM, TRACED = 0, 10**9


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_proc0: float,
             config_override=None, bench_dir: Path = BENCH_DIR,
             log=sys.stderr) -> tuple[dict, list]:
    """Run the cell; returns (result, checks), checks as
    [(name, value, limit)]."""
    t_begin = time.perf_counter()
    device = torch.device(device)
    spec = Spec(root, bench_dir)
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    if config_override is not None:
        cfg = config_override(cfg)
    params = spec.traffic(cell["traffic"])
    fld = spec.field(cfg["field"]["kind"])(cfg["field"])
    reference = spec.operator(cfg["operator"])
    build = spec.system(cfg["system"], params["op"])
    n = int(fld["n_dof"])
    traffic = Traffic(params, seed, n, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)

    t_field = time.perf_counter()
    sut = build(cfg, fld, device)
    t_sut = time.perf_counter()
    # the inputs of a system that solves a given b: b = A x from the
    # reference operator
    ref = None if sut.makes_rhs else reference(fld, cfg, device)

    def rhs(index):
        if ref is None:
            return None
        b = ref.matvec(traffic.x_true(index))
        _sync(device)
        return b

    clock = _Clock(device)

    def one_op(index):
        """Op ``index``: its right-hand side made, then the op timed;
        returns (host seconds, device seconds, result)."""
        b = rhs(index)
        clock.start()
        result = sut.op(b)
        wall, dev = clock.stop()
        return wall, dev, result

    def between_ops():
        if traffic.collect_garbage:
            gc.collect()

    one_op(WARM)
    between_ops()
    _sync(device)
    # what set-up made stays for the run: later collections skip it
    gc.collect()
    gc.freeze()

    # the window: ops back to back; an op started inside runs to its end
    ops, kept, failed = [], {}, 0
    c0 = sut.counters()
    t_start = time.perf_counter()
    setup_s = t_start - t_proc0
    print(f"[bench] set-up {setup_s:.3f} s: start and imports "
          f"{t_begin - t_proc0:.3f}, field {t_field - t_begin:.3f}, "
          f"program set-up {t_sut - t_field:.3f}, warm-up "
          f"{t_start - t_sut:.3f}", file=log)
    t_last = t_start
    index, last = 0, None
    while time.perf_counter() - t_start < seconds:
        index += 1
        check = traffic.checked()
        try:
            wall, dev, r = one_op(index)
        except Exception:                    # an op that raised has failed
            traceback.print_exc(file=log)
            failed += 1
            t_last = time.perf_counter()
            between_ops()
            continue
        t_last = time.perf_counter()
        failed += not r.converged
        ops.append({"wall_s": wall, "device_s": dev, "inner": r.inner,
                    "outer": r.outer, "timers": r.timers})
        if check:
            kept[index] = torch.as_tensor(r.x).cpu()
        last = (index, r.x)
        del r
        between_ops()
    attempted = index
    if last is not None and last[0] not in kept:   # the last, after the close
        kept[last[0]] = torch.as_tensor(last[1]).cpu()
    last = None
    c1 = sut.counters()
    window_s = t_last - t_start
    print(f"[bench] window {window_s:.3f} s: {len(ops)} ops, "
          f"{sum(o['inner'] for o in ops)} inner iterations, counters "
          f"{ {k: c1[k] - c0[k] for k in c1} }; ops (host s, device s, "
          f"inner, outer) "
          f"{[(round(o['wall_s'], 4), round(o['device_s'], 4), o['inner'], o['outer']) for o in ops]}",
          file=log)

    summary = _traced(sut, traffic, rhs, device, log) if trace else None

    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise NoResult(3, f"modules of JAX or the JAX package are loaded: "
                          f"{found}")

    # the check: the program's state freed, the reference on the device
    gc.unfreeze()
    sut.release()
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = ref or reference(fld, cfg, device)
    limit = float(cfg["accuracy"]["tol"])
    residuals = {}
    for idx, x in sorted(kept.items()):
        b = ref.matvec(traffic.x_true(idx))
        residuals[idx] = ref.relative_residual(x, b)
        print(f"[bench] op {idx}: ||b - A x|| / ||b|| = "
              f"{residuals[idx]!r} (reference, float64)", file=log)
    print(f"[bench] reference check of {len(residuals)} of {len(ops)} ops "
          f"in {time.perf_counter() - t0:.2f} s", file=log)
    res_max = max(residuals.values()) if residuals else math.inf
    checks = [("residual_max", res_max, limit), ("failed_ops", failed, 0),
              ("checked_ops", len(residuals), 1)]
    correct = bool(residuals) and res_max <= limit and failed == 0

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    reading = Reading(
        config=cfg, n_dof=n, setup_s=setup_s, window_s=window_s, ops=ops,
        counters={k: c1[k] - c0[k] for k in c1},
        memory_peak_bytes=peak, device_kind=kind,
        roofline=spec.roofline(), trace=summary)
    metrics = {}
    wanted = spec.per_layer(cell_name) if trace \
        else spec.end_to_end(cell_name)
    for m in wanted:
        value = spec.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": int(cell["chips"]),
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks


def _traced(sut, traffic, rhs, device, log) -> tracing.TraceSummary:
    """The traced ops after the window: ``trace_ops`` ops with the device
    alone recorded (busy time, window, device operations), then one
    with the host recorded too (the spans' device times and the idle
    gaps' host ops)."""
    op = sut.traced_op()

    def run(count, first):
        with tracing.span("window"):
            for j in range(count):
                if j and traffic.collect_garbage:
                    gc.collect()
                b = rhs(TRACED + first + j)
                with tracing.span("op"):
                    op(b)
                    _sync(device)

    def marker():
        torch.ones(1, device=device).add_(1)
        _sync(device)

    t0 = time.perf_counter()
    gc.collect()
    with tracing.profiler(device, host=False) as prof:
        marker()
        run(traffic.trace_ops, 0)
        marker()
    summary = tracing.reduce(prof)
    del prof
    t1 = time.perf_counter()
    gc.collect()
    with tracing.profiler(device) as prof:
        run(1, traffic.trace_ops)
    detail = tracing.reduce(prof)
    del prof
    summary.range_calls = detail.range_calls
    summary.range_device_s = detail.range_device_s
    summary.idle_gaps = detail.idle_gaps
    print(f"[bench] trace: {summary.n_device_ops} device ops in "
          f"{t1 - t0:.1f} s; with the host's ops, {detail.n_device_ops} "
          f"in {time.perf_counter() - t1:.1f} s, reductions included",
          file=log)
    return summary


def _args(argv):
    p = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="One run of one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_proc0: float) -> int:
    args = _args(argv)
    root = BENCH_DIR.parent
    for var, sub in CACHES.items():
        os.environ[var] = str(BENCH_DIR / ".cache" / sub)
    try:
        chips = int(Spec(root).cell(args.workload)["chips"])
        if not torch.cuda.is_available():
            raise NoResult(2, "no CUDA device is available")
        if torch.cuda.device_count() < chips:
            raise NoResult(2, f"the cell needs {chips} cards, "
                              f"{torch.cuda.device_count()} are present")
        try:
            import geneo4petsc_tpu_torch  # noqa: F401
        except ImportError as e:
            raise NoResult(2, f"the measured package is missing: {e}")
        result, checks = run_cell(root, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda:0",
                                  t_proc0)
        found = forbidden_modules()
        if found:
            raise NoResult(3, f"modules of JAX or the JAX package are "
                              f"loaded: {found}")
    except NoResult as e:
        print(f"[bench] no result: {e}", file=sys.stderr)
        return e.code
    emit(result, checks, sys.stdout, sys.stderr)
    return 0


def emit(result: dict, checks: list, out, err) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    ``err``; the result as the last line of ``out``."""
    out.flush()
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
