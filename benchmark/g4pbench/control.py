"""The control of the correctness check.

The configurations state float64 refinement to a float64 residual; the
control is the program's own float32 path — the system's
``control_op``: the same preconditioner and inner solver, asked for the
whole tolerance in float32, with no float64 refinement — judged by the
same reference and limit as a run.  It has to come out not correct.
``readings`` also gives the program's own op on the same b, the sound
side.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .spec import BENCH_DIR, Spec
from .traffic import Traffic


def readings(root: Path, cell_name: str, seeds, device, program: bool,
             config_override=None, bench_dir: Path = BENCH_DIR
             ) -> list[dict]:
    """Per seed: the reference's residual of the control's answer and,
    with ``program``, of the program's answer to the same b (the
    seed's first window op), beside the configuration's limit."""
    device = torch.device(device)
    spec = Spec(root, bench_dir)
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    if config_override is not None:
        cfg = config_override(cfg)
    params = spec.traffic(cell["traffic"])
    fld = spec.field(cfg["field"]["kind"])(cfg["field"])
    ref = spec.operator(cfg["operator"])(fld, cfg, device)
    sut = spec.system(cfg["system"], params["op"])(cfg, fld, device)
    limit = float(cfg["accuracy"]["tol"])
    out = []
    for seed in seeds:
        traffic = Traffic(params, seed, int(fld["n_dof"]), device)
        b = ref.matvec(traffic.x_true(1))
        arg = None if sut.makes_rhs else b
        row = {"seed": seed, "limit": limit}
        ctl = sut.control_op(arg)
        row["control_residual"] = ref.relative_residual(ctl.x, b)
        row["control_inner"] = ctl.inner
        if program:
            got = sut.op(arg)
            row["program_residual"] = ref.relative_residual(got.x, b)
            row["program_inner"] = got.inner
        out.append(row)
    return out
