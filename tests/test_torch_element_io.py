"""The port's element-file writer and structured grid re-export against
the JAX package's, on the CPU.

``write_input_file`` writes the reference's element text format: for
the same ``from_lists`` mesh the two packages' files are byte-identical,
and each package reads the other's file back to the same element
matrices (exactly: ``repr`` round-trips a float64).
``laplacian_structured`` is ``laplacian_grid`` under the JAX package's
public name, and gives the JAX package's grid."""

import numpy as np
import pytest

from geneo4petsc_tpu.io import element_input as jei
from geneo4petsc_tpu.structured.solve import \
    laplacian_structured as jax_laplacian_structured
from geneo4petsc_tpu_torch.io import element_input as tei
from geneo4petsc_tpu_torch.structured.grid import laplacian_grid
from geneo4petsc_tpu_torch.structured.solve import laplacian_structured


def _meshes():
    rng = np.random.default_rng(0)
    dofs = [[0, 1, 4, 3], [1, 2, 5, 4], [3, 4, 7, 6], [4, 5, 8, 7], [8]]
    mats = [rng.standard_normal((len(d), len(d))) for d in dofs]
    return {
        # the JAX package's tests/test_input.py round trip
        "default-mats": ([[0, 1], [1, 2], [2]], None, 0.25),
        "seeded-mats": (dofs, mats, 0.0001),
        "mixed": (dofs, mats[:2] + [None] * 3, 0.5),
    }


MESHES = _meshes()


@pytest.mark.parametrize("name", MESHES)
def test_files_byte_identical_and_cross_read(name, tmp_path):
    dofs, mats, eps = MESHES[name]
    jax_path, port_path = tmp_path / "jax.inp", tmp_path / "port.inp"
    jei.write_input_file(jei.from_lists(dofs, mats, inp_eps=eps),
                         str(jax_path))
    tei.write_input_file(tei.from_lists(dofs, mats, inp_eps=eps),
                         str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    want = tei.from_lists(dofs, mats, inp_eps=eps)
    for back in (jei.read_input_file(str(port_path)),
                 tei.read_input_file(str(jax_path))):
        assert back.n_nodes == want.n_nodes
        assert np.array_equal(back.elem_ptr, want.elem_ptr)
        assert np.array_equal(back.elem_idx, want.elem_idx)
        for a, b in zip(back.elem_mats, want.elem_mats):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(size=6, dim=3, kappa_max=1e4, interp="minmax"),
    dict(size=8, dim=2, kappa_max=100.0, interp="", inp_eps=0.01),
    dict(size=5, dim=3, weak_scaling=2),
])
def test_laplacian_structured_is_laplacian_grid(kw):
    got = laplacian_structured(**kw)
    want = laplacian_grid(**kw)
    jax = jax_laplacian_structured(**kw)
    for g in (want, jax):
        assert got.shape == g.shape and got.dim == g.dim
        assert got.inp_eps == g.inp_eps
        assert np.array_equal(got.kappa, g.kappa)
        assert np.array_equal(got.diag(), np.asarray(g.diag()))
    x = np.arange(1.0, got.n_nodes + 1)
    assert np.array_equal(got.matvec(x), np.asarray(jax.matvec(x)))
