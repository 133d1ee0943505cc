"""-geneo_chk, -geneo_dbg F,D, --debug F and the divergence dump of the
PyTorch port against the JAX package (float64, on the CPU): the same
CLI arguments run through both packages' CLIs, each in a directory of
its own, must write the same file set with the same line structure.

Numbers: the inputs and setup artifacts are written from the same
arrays, so their files are byte-equal (the PETSc binaries included);
files that hold a solution, a preconditioned vector or a residual
history agree to 1e-9 relative (the test_torch_precond.py parity of one
apply); timing files name the same phases; the eigensolver failure logs
name the same domains and kept-column counts."""

import io
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp

from geneo4petsc_tpu import cli as jax_cli
from geneo4petsc_tpu.utils import check as jcheck
from geneo4petsc_tpu.utils import petsc_format as jpf
from geneo4petsc_tpu_torch import cli
from geneo4petsc_tpu_torch.utils import check as tcheck
from geneo4petsc_tpu_torch.utils import petsc_format as tpf

LAP6 = ["--inpLibA", "laplacian", "--inpLibArg", "--size#6#--dim#2"]
_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _run_both(args, tmp_path, monkeypatch):
    """Run the JAX CLI and the port's CLI (--device cpu) on ``args`` in
    tmp/jax and tmp/port; returns {pkg: (rc, stdout, dir)}."""
    out = {}
    for pkg, run, extra in (("jax", jax_cli.run, []),
                            ("port", cli.run, ["--device", "cpu"])):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        buf = io.StringIO()
        rc = run(args + extra, out=buf)
        out[pkg] = (rc, buf.getvalue(), work)
    monkeypatch.chdir(tmp_path)
    return out


def _same_numbers(a: str, b: str, rtol: float) -> bool:
    """Equal text but for numbers, which agree to ``rtol``."""
    if _NUM.sub("#", a) != _NUM.sub("#", b):
        return False
    x = np.array([float(t) for t in _NUM.findall(a)])
    y = np.array([float(t) for t in _NUM.findall(b)])
    return x.shape == y.shape and np.allclose(x, y, rtol=rtol, atol=0)


def _read_bin(path):
    with open(path, "rb") as f:
        classid = int(np.fromfile(f, ">i4", 1)[0])
    if classid == tpf.VEC_FILE_CLASSID:
        return tpf.read_vec_bin(str(path))
    return tpf.read_mat_bin(str(path)).toarray()


# files written from a solve's iterate or one preconditioned vector:
# numerically equal, not bytewise
_COMPUTED = ("debug.output.X.bin", "debug.output.X.log",
             "debug.apply001.scatter.out", "debug.apply.residual.log")


def _compare_dirs(jdir, pdir):
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir))
    for name in files:
        j, p = jdir / name, pdir / name
        if name.endswith(".bin"):
            if name.startswith(_COMPUTED):
                np.testing.assert_allclose(_read_bin(p), _read_bin(j),
                                           rtol=1e-9)
            else:
                assert p.read_bytes() == j.read_bytes(), name
            continue
        jl, pl = j.read_text().splitlines(), p.read_text().splitlines()
        assert len(jl) == len(pl), name
        if name.endswith("timing.log"):
            assert [ln.split(":")[0] for ln in pl] == \
                [ln.split(":")[0] for ln in jl]
        elif name.startswith(_COMPUTED):
            assert all(_same_numbers(a, b, 1e-9) for a, b in zip(pl, jl)), \
                name
        else:
            assert pl == jl, name
    return files


@pytest.mark.parametrize("label,args", [
    ("dbg log,2", LAP6 + ["--nbPart", "3", "-pc_type", "geneo",
                          "-geneo_lvl", "RAS,1", "-geneo_dbg", "log,2"]),
    ("dbg bin,2", LAP6 + ["--nbPart", "2", "-pc_type", "geneo",
                          "-geneo_lvl", "SORAS,2", "-geneo_dbg", "bin,2"]),
    ("debug bin", LAP6 + ["--nbPart", "2", "-pc_type", "geneo",
                          "-geneo_lvl", "ASM,1", "--debug", "bin"]),
    ("debug mat + dbg mat,2", LAP6 + ["--nbPart", "2", "-pc_type", "geneo",
                                      "-geneo_lvl", "ASM,1", "--debug",
                                      "mat", "-geneo_dbg", "mat,2"]),
    ("chk + dbg log,1", LAP6 + ["--nbPart", "2", "-pc_type", "geneo",
                                "-geneo_lvl", "ASM,E1", "-geneo_chk", "log",
                                "-geneo_dbg", "log,1"]),
])
def test_dump_files_match_jax(label, args, tmp_path, monkeypatch):
    runs = _run_both(args + ["--shortRes"], tmp_path, monkeypatch)
    assert runs["jax"][0] == runs["port"][0] == 0
    assert runs["port"][1] == runs["jax"][1]
    files = _compare_dirs(runs["jax"][2], runs["port"][2])
    assert "debug.timing.log" in files or "--debug" in args
    if label == "chk + dbg log,1":
        assert files == ["debug.timing.log"]
    if label == "dbg log,2":
        for name in ("debug0.setup.ANeu.log", "debug2.setup.ADir.log",
                     "debug1.input.dof.log", "debug0.setup.Z.log",
                     "debug0.setup.tau.ev.log", "debug.setup.E.eig.log",
                     "debug0.input.intersect.log",
                     "debug0.setup.sylvester.inertia.log",
                     "debug0.apply001.scatter.in.log",
                     "debug.apply001.scatter.out.log"):
            assert name in files
    if label == "debug bin":
        pdir = runs["port"][2]
        x = tpf.read_vec_bin(str(pdir / "debug.output.X.bin"))
        a = tpf.read_mat_bin(str(pdir / "debug.input.A.bin"))
        b = tpf.read_vec_bin(str(pdir / "debug.input.B.bin"))
        assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-4
        np.testing.assert_allclose(
            x, np.loadtxt(pdir / "debug.output.X.log"), rtol=1e-10)


def test_failure_dump_on_divergence_matches_jax(tmp_path, monkeypatch):
    """A DIVERGED_* outcome dumps the Krylov and PC state with debugging
    off (checkKSPSolve, geneo.cpp:1397-1433); a converged one does
    not."""
    args = ["--inpLibA", "laplacian", "--inpLibArg",
            "--size#12#--dim#2#--kappa#100000.#quad", "--nbPart", "4",
            "-pc_type", "none", "-ksp_type", "cg", "-ksp_max_it", "3",
            "-ksp_rtol", "1e-12"]
    runs = _run_both(args, tmp_path, monkeypatch)
    assert runs["jax"][0] == runs["port"][0] == 0
    assert "diverged" in runs["port"][1]
    jl = (runs["jax"][2] / "debug.failure.ksp.log").read_text().splitlines()
    pl = (runs["port"][2] / "debug.failure.ksp.log").read_text().splitlines()
    assert pl[0] == jl[0] == "reason: KSP_DIVERGED_ITS (-3)"
    assert "residual history:" in pl and len(pl) == len(jl)
    assert all(_same_numbers(a, b, 1e-9) for a, b in zip(pl, jl))
    ok_dir = tmp_path / "converged"
    ok_dir.mkdir()
    ok = _run_both(LAP6 + ["--nbPart", "2", "-pc_type", "geneo",
                           "-geneo_lvl", "ASM,1", "--shortRes"], ok_dir,
                   monkeypatch)
    assert not os.listdir(ok["port"][2]) and not os.listdir(ok["jax"][2])


def test_eigensolver_check_aborts_like_jax(tmp_path, monkeypatch):
    """Kept eigenpairs above an eigensolver tolerance pinned below the
    LOBPCG residual floor (the JAX package's test_debug_dumps.py case)
    print the WRNG line, and -geneo_chk aborts (exit 2) after dumping the
    per-domain eigensolver state (checkEPSSolve, geneo.cpp:577-624)."""
    args = ["--inpLibA", "laplacian", "--inpLibArg",
            "--size#16#--dim#2#--kappa#100000.#quad", "--nbPart", "4",
            "-pc_type", "geneo", "-geneo_lvl", "ASM,1", "-geneo_cut", "2",
            "-els2_type", "lobpcg", "-els2_max_it", "1", "-els2_eps_tol",
            "1e-12", "-ksp_max_it", "500", "-geneo_chk", "log"]
    runs = _run_both(args, tmp_path, monkeypatch)
    assert runs["jax"][0] == runs["port"][0] == 2
    files = sorted(os.listdir(runs["port"][2]))
    assert files == sorted(os.listdir(runs["jax"][2]))
    assert files and all(f.endswith(".eps.failure.log") for f in files)
    for name in files:
        pl = (runs["port"][2] / name).read_text().splitlines()
        jl = (runs["jax"][2] / name).read_text().splitlines()
        assert pl[1] == jl[1] and len(pl) == len(jl)    # kept columns
    buf = io.StringIO()
    monkeypatch.chdir(tmp_path)
    assert cli.run(args[:-2] + ["--device", "cpu"], out=buf) == 0
    assert "WRNG: eigensolver residual" in buf.getvalue()


def test_petsc_writers_and_readers_match_jax(tmp_path):
    """The Matlab and PetscViewerBinary writers give the JAX package's
    bytes on the same arrays; the readers give the arrays back."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(17)
    a = rng.standard_normal((9, 7)) * (rng.random((9, 7)) > 0.6)
    csr = sp.random(12, 12, density=0.3, random_state=1, format="csr")
    assert tpf.format_vec_matlab(v, "B") == jpf.format_vec_matlab(v, "B")
    assert tpf.format_mat_matlab(a, "A") == jpf.format_mat_matlab(a, "A")
    for name, write_t, write_j, arr in (
            ("v", tpf.write_vec_bin, jpf.write_vec_bin, v),
            ("a", tpf.write_mat_bin, jpf.write_mat_bin, a),
            ("csr", tpf.write_mat_bin, jpf.write_mat_bin, csr)):
        write_t(str(tmp_path / f"{name}.t"), arr)
        write_j(str(tmp_path / f"{name}.j"), arr)
        assert (tmp_path / f"{name}.t").read_bytes() == \
            (tmp_path / f"{name}.j").read_bytes()
    np.testing.assert_array_equal(tpf.read_vec_bin(str(tmp_path / "v.t")), v)
    np.testing.assert_array_equal(
        tpf.read_mat_bin(str(tmp_path / "a.t")).toarray(), a)
    got = tpf.read_mat_bin(str(tmp_path / "csr.t"))
    want = jpf.read_mat_bin(str(tmp_path / "csr.j"))
    assert (got != want).nnz == 0 and (got != csr).nnz == 0


def test_checks_raise_like_jax(tmp_path, monkeypatch):
    """Each check fails on the same bad input with the JAX package's
    message."""
    monkeypatch.chdir(tmp_path)
    bad = [(lambda m: m.check_spd(np.array([[1.0, 2.0], [0.0, 1.0]]), "A"),
            "not symmetric"),
           (lambda m: m.check_spd(np.diag([1.0, -1.0]), "A"), "not SPD"),
           (lambda m: m.check_pou(np.array([0.5, 0.0]),
                                  np.array([True, True])),
            "partition of unity"),
           (lambda m: m.check_rank_z(np.ones((4, 2))), "check rank")]
    for fn, what in bad:
        with pytest.raises(tcheck.CheckError, match=what) as got:
            fn(tcheck)
        with pytest.raises(jcheck.CheckError) as want:
            fn(jcheck)
        assert str(got.value) == str(want.value)
    tcheck.check_spd(np.eye(3), "A")
    tcheck.check_rank_z(np.eye(4)[:, :2])
