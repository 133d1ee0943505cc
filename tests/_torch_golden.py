"""The generic entries of tst/golden/iteration_counts.json with the CLI
arguments tst/iters.py runs them with, for the port's golden tests
(tests/test_torch_golden_*.py, one file per workload so that
``--dist loadfile`` spreads them over the workers)."""

import io
import json
import os
import re

from geneo4petsc_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tst", "golden", "iteration_counts.json")

# tst/sweep.py's PC_MATRIX without mg (tst/iters.py leaves it out), its
# GENERATOR_ARGS and tst/iters.py's SIZES
PCS = ["-pc_type#bjacobi"] + [
    f"-pc_type#geneo#-geneo_lvl#{lvl}{extra}"
    for lvl, extras in (("ASM,0", [""]),
                        ("ASM,1", ["", "##--addOverlap#1", "##-geneo_offload"]),
                        ("ASM,H1", ["", "#--addOverlap#1", "#-geneo_offload"]),
                        ("ASM,E1", ["", "#--addOverlap#1", "#-geneo_offload"]),
                        ("SORAS,0", [""]),
                        ("SORAS,2", ["", "##--addOverlap#1",
                                     "##-geneo_offload"]),
                        ("SORAS,H2", ["", "#--addOverlap#1",
                                      "#-geneo_offload"]),
                        ("SORAS,E2", ["", "#--addOverlap#1",
                                      "#-geneo_offload"]))
    for extra in extras]
GENERATOR_ARGS = {
    "laplacian": "--size#10#--weakScaling#1#--dim#2",
    "heat": "--size#10#--weakScaling#1#--dim#2#--lbd#2.#--dt#0.5",
    "graph": "--size#16#--weakScaling#1",
}

_RE_SOLVE = re.compile(r"INFO: solve - (converged|diverged) \(([A-Z_]+)\), "
                       r"(\d+) iteration\(s\)")
_RE_DIME = re.compile(r"real dimE (\d+) .*nicolaides (\d+)")


def _log_name(pc: str) -> str:
    """tst/sweep.py pc_log_name."""
    s = pc.replace("#", "").replace("-", "").replace(",", "")
    s = s.replace("pc_type", "").replace("geneo_lvl", "")
    return s.replace("addOverlap1", "").replace("geneo_offload", "")


def golden_cases(workload: str) -> list:
    """[(name, cli args, pinned counts)] of one workload, as tst/iters.py
    builds them; every one of them is in the golden file."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    cases = []
    for metis in ("--metisDual", "--metisNodal"):
        m_log = "dual" if metis == "--metisDual" else "nodal"
        for pc in PCS:
            lvl2 = any(x in pc for x in (",1", ",2", "H1", "H2", "E1", "E2"))
            for tg in ([("0.1", "8."), ("0.2", "12.")] if lvl2 else [None]):
                name = f"{workload}-np=2-pc={_log_name(pc)}-metis={m_log}"
                if tg is not None and tg != ("0.1", "8."):
                    name += f"-tau={tg[0]}-gamma={tg[1]}"
                if "addOverlap" in pc:
                    name += "-overlap1"
                if "offload" in pc:
                    name += "-offload"
                args = ["--inpLibA", workload, "--inpLibArg",
                        GENERATOR_ARGS[workload], "--nbPart", "2", metis,
                        "--device", "cpu",
                        "-ksp_rtol", "1.e-05", "-ksp_atol", "1.e-05",
                        "-ksp_max_it", "1000", "-ksp_gmres_restart", "1000"]
                args += pc.replace("##", "#").strip("#").split("#")
                if tg is not None:
                    args += ["-geneo_tau", tg[0], "-geneo_gamma", tg[1]]
                if "SORAS" in pc:
                    args += ["-geneo_optim", "0.00"]
                cases.append((name, args, golden[name]))
    return cases


def run_case(args) -> dict:
    """The counts the port's CLI prints for one entry."""
    buf = io.StringIO()
    assert cli.run(args, out=buf) == 0
    log = buf.getvalue()
    m = _RE_SOLVE.search(log)
    assert m is not None and m.group(1) == "converged", log
    got = {"its": int(m.group(3))}
    md = _RE_DIME.search(log)
    if md is not None:
        got["dim_e"], got["nicolaides"] = int(md.group(1)), int(md.group(2))
    return got
