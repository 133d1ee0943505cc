"""A tiny CPU run of each traffic mix through the harness's code path,
and the command line's refusals."""

import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT, shrink
from g4pbench import runner

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["lap10m.fresh", "lap10m.reuse"])
def test_dry_run_prints_the_result_line(cell, trace):
    result, checks = runner.run_cell(
        ROOT, cell, 2**31 + 77, 0.3, bool(trace), "cpu",
        time.perf_counter(), config_override=shrink(12))
    out, err = io.StringIO(), io.StringIO()
    runner.emit(result, checks, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = runner.Spec(ROOT)
    names = [m["name"] for m in (spec.per_layer(cell) if trace
                                 else spec.end_to_end(cell))]
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert "setup_s" in line["metrics"]
        assert {"time_to_solution_s", "resolve_s"} & set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().splitlines()[-len(checks):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    assert list(line["checks"]) == [c[0] for c in checks]


def test_no_card_no_result(capsys):
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = runner.main(["--workload", "lap10m.fresh", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       time.perf_counter())
    assert code != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lap10m.fresh",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
