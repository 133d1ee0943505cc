"""A configuration with its field, reference operator and system, a
traffic mix and a per-layer metric are added as files and entries, and
the harness finds them by name, with no file of the benchmark edited."""

import hashlib
import json
import shutil
import time

from conftest import BENCH, ROOT
from g4pbench import runner

# a field kind: kappa constant on each z-plane, 1 to kappa_max
FIELD = '''
import numpy as np


def make(params):
    n = int(params["size"])
    kz = np.logspace(0.0, np.log10(params["kappa_max"]), n)
    kappa = np.broadcast_to(kz[:, None, None], (n, n, n)).copy()
    return {"shape": (n, n, n), "kappa": kappa, "dim": 3,
            "separable": True, "n_dof": n ** 3}
'''

# a reference operator: the same element formula, assembled as a sparse
# matrix instead of applied plane by plane
OPERATOR = '''
import numpy as np
import torch


def build(field, cfg, device="cpu"):
    return Csr7Point(field["kappa"], cfg["inp_eps"], device)


class Csr7Point:
    def __init__(self, kappa, eps, device):
        k = np.asarray(kappa, np.float64)
        ids = np.arange(k.size).reshape(k.shape)
        rows, cols, vals = [], [], []
        for ax in range(3):
            m = k.shape[ax]
            lo = np.take(ids, range(m - 1), axis=ax).ravel()
            hi = np.take(ids, range(1, m), axis=ax).ravel()
            c = np.take(k, range(m - 1), axis=ax).ravel()
            for i, j in ((lo, hi), (hi, lo)):
                rows += [i, i]
                cols += [i, j]
                vals += [c * (1 + eps), -c]
        bottom = ids[0].ravel()
        rows.append(bottom)
        cols.append(bottom)
        vals.append(k[0].ravel() * (1 + eps))
        self.n = k.size
        idx = torch.tensor(np.stack([np.concatenate(rows),
                                     np.concatenate(cols)]))
        self.a = torch.sparse_coo_tensor(
            idx, torch.tensor(np.concatenate(vals)), (self.n, self.n),
            device=device).coalesce().to_sparse_csr()

    def matvec(self, x):
        return self.a @ x.to(torch.float64)

    def relative_residual(self, x, b):
        x = torch.as_tensor(x).to(b.device, torch.float64)
        return float(torch.linalg.vector_norm(b - self.matvec(x))
                     / torch.linalg.vector_norm(b))
'''

# a system: the program's float64 stencil under a plain conjugate
# gradient of the test's own, one given b an op
SYSTEM = '''
import torch
from geneo4petsc_tpu_torch.structured.grid import (StructuredGrid,
                                                   global_stencil)

from g4pbench.program import OpResult


class PlainCG:
    makes_rhs = False

    def __init__(self, cfg, field, device):
        grid = StructuredGrid(shape=tuple(field["shape"]),
                              kappa=field["kappa"],
                              inp_eps=cfg["inp_eps"], dim=field["dim"],
                              separable_hint=field["separable"])
        self.op64 = global_stencil(grid, torch.float64, device)
        self.tol = cfg["accuracy"]["tol"]
        self.its = 0

    def op(self, b):
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rr = r @ r
        bn = float(torch.linalg.vector_norm(b))
        k = 0
        while float(rr) ** 0.5 > 0.1 * self.tol * bn and k < 2000:
            q = self.op64.matvec(p)
            a = rr / (p @ q)
            x += a * p
            r -= a * q
            rr, rr_old = r @ r, rr
            p = r + (rr / rr_old) * p
            k += 1
        self.its += k
        return OpResult(x=x, inner=k, outer=1, converged=k < 2000)

    def traced_op(self):
        return self.op

    def control_op(self, b):
        return self.op(b)

    def counters(self):
        return {"cg_iterations": self.its}

    def release(self):
        del self.op64


def build(cfg, field, device):
    return PlainCG(cfg, field, device)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    before = _digests(bench)

    (bench / "reference" / "fields" / "zlayers.py").write_text(FIELD)
    (bench / "reference" / "csr_7point.py").write_text(OPERATOR)
    (bench / "systems" / "plaincg.resolve.py").write_text(SYSTEM)
    cfg = json.loads((bench / "configs" / "lap10m.json").read_text())
    cfg.update(name="zlayers_small", system="plaincg",
               operator="csr_7point",
               field={"kind": "zlayers", "size": 8, "kappa_max": 100.0})
    (bench / "configs" / "zlayers_small.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "reuse.json").read_text())
    mix.update(rhs="manufactured", check_share=1.0)
    (bench / "traffic" / "smooth.json").write_text(json.dumps(mix))
    (bench / "metrics" / "cg_iters.smooth.py").write_text(
        "def read(t):\n"
        "    return t.counters['cg_iterations'] / len(t.ops)\n")

    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zlayers_small", "source": "test",
                            "file": "benchmark/configs/zlayers_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "zlayers_small.smooth",
                              "config": "zlayers_small",
                              "traffic": "smooth", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "resolve_s":
            m["workloads"].append("zlayers_small.smooth")
    spec["per_layer"].append({
        "name": "cg_iters.smooth", "unit": "its/solve", "better": "lower",
        "source": "program_counter", "layer": "refinement and Krylov",
        "moves": "resolve_s", "workloads": ["zlayers_small.smooth"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    for trace, name in ((0, "resolve_s"), (1, "cg_iters.smooth")):
        result, checks = runner.run_cell(
            tmp_path, "zlayers_small.smooth", 9, 0.3, bool(trace), "cpu",
            time.perf_counter(), bench_dir=bench)
        assert result["correct"] is True, checks
        assert name in result["metrics"]
    assert result["metrics"]["cg_iters.smooth"]["value"] >= 1
    after = _digests(bench)
    assert {k: after[k] for k in before} == before
