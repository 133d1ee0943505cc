"""Configuration dataclasses of the PyTorch port.

The reference (geneo4PETSc) is double-precision throughout (PETSc default
scalar), and so is the port: ``DEFAULT_DTYPE`` is ``torch.float64`` on
every device (the H100 has native IEEE float64).

Mirrors the reference's three-layer flag system (checkArguments /
PetscOptions / -geneo_* — see src/geneo4PETSc.cpp:1396-1495 and
src/geneo.cpp:2329-2514) with one flat dataclass tree keyed by the same
option-prefix namespaces (dls1_, syl2_, els2_, dcs2_, ubl2_).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

DEFAULT_DTYPE = torch.float64


@dataclass
class SubSolverOptions:
    """Per-sub-solver namespace (reference option prefixes dls1_/els2_/...).

    type: "cholesky" (default; all reference operators are SPD) or "lu".
    """

    type: str = "cholesky"
    rtol: float = 1e-5
    atol: float = 1e-50
    max_it: int = 10000


@dataclass
class GenEOOptions:
    """Mirror of -geneo_* options (src/geneo.cpp:2329-2514, defaults
    src/geneo.cpp:2649-2662)."""

    lvl1: str = "ASM"  # ASM | RAS | SRAS | ORAS | SORAS
    lvl2: str = "1"    # 0 | 1 | H1 | E1 | 2 | H2 | E2
    optim: float = 0.0
    tau: float = 0.1
    gamma: float = 10.0
    cst: bool = False
    cut: int = -1
    no_syl: bool = False
    offload: bool = False  # kept for CLI parity; the coarse solve is replicated
    dls1: SubSolverOptions = field(default_factory=SubSolverOptions)
    syl2: SubSolverOptions = field(default_factory=SubSolverOptions)
    els2: SubSolverOptions = field(
        default_factory=lambda: SubSolverOptions(type="eigh", rtol=1e-3))
    dcs2: SubSolverOptions = field(default_factory=SubSolverOptions)
    ubl2: SubSolverOptions = field(default_factory=SubSolverOptions)

    # --- derived flags (buildGenEOName semantics, geneo.cpp:2245-2268) ---
    @property
    def lvl1_asm(self) -> bool:
        return self.lvl1 == "ASM"

    @property
    def lvl1_ras(self) -> bool:
        return self.lvl1 in ("RAS", "SRAS", "ORAS", "SORAS")

    @property
    def lvl1_sras(self) -> bool:
        return self.lvl1 in ("SRAS", "SORAS")

    @property
    def lvl1_oras(self) -> bool:
        return self.lvl1 in ("ORAS", "SORAS")

    @property
    def lvl2_num(self) -> int:
        return {"0": 0, "1": 1, "H1": 1, "E1": 1, "2": 2, "H2": 2, "E2": 2}[self.lvl2]

    @property
    def hybrid(self) -> bool:
        return self.lvl2 in ("H1", "E1", "H2", "E2")

    @property
    def eff_hybrid(self) -> bool:
        return self.lvl2 in ("E1", "E2")

    @property
    def name(self) -> str:
        name = "geneo" + str(self.lvl2_num)
        if self.hybrid:
            name += "E" if self.eff_hybrid else "H"
        return name + self.lvl1

    def validate(self) -> None:
        if self.lvl1 not in ("ASM", "RAS", "SRAS", "ORAS", "SORAS"):
            raise ValueError(f"invalid -geneo_lvl L1: {self.lvl1}")
        if self.lvl2 not in ("0", "1", "H1", "E1", "2", "H2", "E2"):
            raise ValueError(f"invalid -geneo_lvl L2: {self.lvl2}")
        if self.lvl2_num >= 1 and not (0.0 < self.tau < 1.0):
            raise ValueError("GenEO preconditioner: tau must be in (0, 1)")
        if self.lvl2_num >= 2 and self.gamma <= 1.0:
            raise ValueError("GenEO preconditioner: gamma must be > 1.")


@dataclass
class KSPOptions:
    """Outer Krylov options (PETSc KSP defaults)."""

    type: str = "gmres"  # gmres | cg
    rtol: float = 1e-5
    atol: float = 1e-50
    dtol: float = 1e4
    max_it: int = 10000
    restart: int = 30  # GMRES restart (PETSc default)
    norm_type: str = "preconditioned"  # preconditioned | unpreconditioned | natural


@dataclass
class DriverOptions:
    """Mirror of the reference CLI driver options (geneo4PETSc.cpp:1396-1495).

    ``device``: where the solve runs, "cuda" or "cpu" (``--device``).
    ``structured``: "GX,GY,GZ" box decomposition of the structured scale
    path (``--structured``), "" for the generic path.
    ``n_devices``: ranks of the solve (``--nbDevices D``; "auto": the
    group's size, or the cards of a cuda run), None for one process.
    """

    inp_file_a: str = ""
    inp_eps: float = 0.0001
    inp_lib_a: str = ""
    inp_lib_arg: str = ""
    inp_file_b: str = ""
    metis_dual: bool = True
    use_mat_mpi: bool = True
    add_overlap: int = 0
    verbose: int = 0
    timing: bool = False
    short_res: bool = False
    cmd_line: bool = False
    n_parts: int = 2  # "mpirun -n" equivalent: number of subdomains
    # --debug log|bin|mat: the CLI's input and output dump files
    debug: bool = False
    debug_bin: bool = False
    debug_mat: bool = False
    device: str = "cuda"
    structured: str = ""
    n_devices: int | str | None = None
    # -pc_mg_* options (the reference sweep's MG_OPT,
    # tst/laplacian/laplacianRun.sh: "-pc_mg_cycle_type w
    # -pc_mg_smoothup 5 -pc_mg_smoothdown 5")
    mg_cycle_type: str = "v"
    mg_smooth_down: int = 1
    mg_smooth_up: int = 1
