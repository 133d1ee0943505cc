"""Find a cell's configuration, traffic mix and metrics by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return "g4pbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


class Spec:
    """``BENCHMARK.json`` under ``root``, with the benchmark's folder
    ``bench_dir`` (where ``systems/``, ``traffic/``, ``metrics/`` and
    ``reference/`` live)."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list that move one of its end-to-end
        metrics."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """``read(t)`` of ``metrics/<metric>.py``."""
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           _module_name("metric", metric)).read

    def field(self, kind: str):
        """``make(params)`` of ``reference/fields/<kind>.py``."""
        return load_module(
            self.bench_dir / "reference" / "fields" / f"{kind}.py",
            _module_name("field", kind)).make

    def operator(self, name: str):
        """``build(field, cfg, device)`` of ``reference/<name>.py``: the
        plain reference operator, with ``n``, ``matvec(x)`` and
        ``relative_residual(x, b)``."""
        return load_module(self.bench_dir / "reference" / f"{name}.py",
                           _module_name("operator", name)).build

    def system(self, program: str, op: str):
        """``build(cfg, field, device)`` of
        ``systems/<program>.<op>.py``: the system under test running
        one op kind."""
        name = f"{program}.{op}"
        return load_module(self.bench_dir / "systems" / f"{name}.py",
                           _module_name("system", name)).build

    def roofline(self):
        return load_module(self.bench_dir / "reference" / "roofline.py",
                           _module_name("reference", "roofline"))
