"""The frozen generator and the plain reference operator against the
measured package, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from geneo4petsc_tpu_torch.structured import grid as sgrid
from reference import kappa_7point
from reference.fields import laplacian


@pytest.mark.parametrize("params", [
    dict(size=12, dim=3, kappa_max=1e4, interp="minmax"),
    dict(size=9, dim=2, kappa_max=100.0, interp="quad"),
    dict(size=10, dim=3, kappa_max=50.0, interp="lin", weak_scaling=2),
])
def test_laplacian_field_is_the_programs(params):
    f = laplacian.make(params)
    g = sgrid.laplacian_grid(params["size"], dim=params["dim"],
                             kappa_max=params["kappa_max"],
                             interp=params["interp"],
                             weak_scaling=params.get("weak_scaling", 1))
    assert tuple(f["shape"]) == tuple(g.shape)
    assert np.array_equal(f["kappa"], g.kappa)
    assert f["separable"] is True
    assert f["n_dof"] == g.n_nodes


def _abs_product(f, eps, x):
    """|A| |x| by the element formula, for a rounding bound."""
    k = torch.as_tensor(f["kappa"])
    u = x.abs().reshape(k.shape)
    y = torch.zeros_like(u)
    for ax in range(3):
        m = k.shape[ax]
        if m == 1:
            continue
        c = k.narrow(ax, 0, m - 1)
        lo, hi = u.narrow(ax, 0, m - 1), u.narrow(ax, 1, m - 1)
        y.narrow(ax, 0, m - 1).add_(c * ((1 + eps) * lo + hi))
        y.narrow(ax, 1, m - 1).add_(c * ((1 + eps) * hi + lo))
    bc = 3 - f["dim"]
    y.narrow(bc, 0, 1).add_((1 + eps) * k.narrow(bc, 0, 1)
                            * u.narrow(bc, 0, 1))
    return y.reshape(-1)


def _grids():
    lap = laplacian.make(dict(size=10, dim=3, kappa_max=1e4,
                              interp="minmax"))
    # a field that is not separable: kappa from 1 to 1e4, drawn
    rng = np.random.default_rng(7)
    kappa = 10.0 ** rng.uniform(0.0, 4.0, size=(11, 13, 12))
    rough = {"shape": (12, 13, 11), "kappa": kappa, "dim": 3,
             "separable": False, "n_dof": kappa.size}
    lap2 = laplacian.make(dict(size=9, dim=2, kappa_max=10.0,
                               interp="lin"))
    return [lap, rough, lap2]


@pytest.mark.parametrize("f", _grids(), ids=["lap3", "rough3", "lap2"])
def test_reference_operator_equals_the_programs_stencil(f):
    eps = 1e-4
    g = sgrid.StructuredGrid(shape=tuple(f["shape"]),
                             kappa=np.array(f["kappa"]), inp_eps=eps,
                             dim=f["dim"], separable_hint=f["separable"])
    gop = sgrid.global_stencil(g, torch.float64, "cpu")
    ref = kappa_7point.build(f, {"inp_eps": eps})
    x = torch.randn(g.n_nodes, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    got = ref.matvec(x)
    # equal to rounding: within a few float64 roundings of |A| |x|
    tol = 8 * np.finfo(np.float64).eps * _abs_product(f, eps, x)
    assert bool(((got - gop.matvec(x)).abs() <= tol).all())
    # and to the program's host assembly
    host = torch.from_numpy(g.matvec(x.numpy()))
    assert bool(((got - host).abs() <= tol).all())


def test_relative_residual_reads_the_solution():
    f = _grids()[0]
    ref = kappa_7point.build(f, {"inp_eps": 1e-4})
    x = torch.arange(1, ref.n + 1, dtype=torch.float64)
    b = ref.matvec(x)
    assert ref.relative_residual(x, b) < 1e-15
    # one entry off by 1e-6 of itself, where kappa is largest
    y = x.clone()
    k = int(torch.argmax(ref.kappa.reshape(-1)))
    y[k] *= 1.0 + 1e-6
    assert ref.relative_residual(y, b) > 1e-8
