"""Carry state across from the JAX package.

The JAX package's ``SubdomainBatch`` (also ``api.make_batch``'s),
``GenEOPreconditioner``, ``BlockJacobiPreconditioner``,
``MGPreconditioner`` and the elastic ``ElasticGenEO`` are handed over as
NumPy arrays (their data leaves) plus their static fields, and rebuilt
here as the port's objects on a given device, so both packages can apply
the very same preconditioner.  Only NumPy arrays cross: nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.assemble import SubdomainBatch, batch_from_host
from ..precond.bjacobi import BlockJacobiPreconditioner, bjacobi_from_factors
from ..precond.geneo import GenEOPreconditioner
from ..precond.mg import MGPreconditioner, mg_from_levels

_BATCH_KEYS = ("gids", "mask", "mult", "a_neu", "a_dir")
PC_META = ("lvl1", "lvl2", "hybrid", "eff_hybrid", "dim_e", "k_max",
           "l1_kind")


def batch_from_arrays(d: dict, device) -> SubdomainBatch:
    """``d``: the batch leaves ``gids``, ``mask``, ``mult``, ``a_neu`` and
    ``a_dir`` (None allowed) as arrays, and ``n_dof``.  The dtype follows
    ``a_neu``."""
    missing = [k for k in (*_BATCH_KEYS, "n_dof") if k not in d]
    if missing:
        raise KeyError(f"batch_from_arrays: missing {missing}")
    a_neu = np.asarray(d["a_neu"])
    dtype = torch.from_numpy(np.empty(0, a_neu.dtype)).dtype
    a_dir = None if d["a_dir"] is None else np.asarray(d["a_dir"])
    return batch_from_host(np.asarray(d["gids"]), np.asarray(d["mask"]),
                           np.asarray(d["mult"]), a_neu, a_dir,
                           int(d["n_dof"]), device, dtype)


def pc_from_arrays(d: dict, meta: dict, device) -> GenEOPreconditioner:
    """``d``: the batch leaves (see batch_from_arrays) plus ``l1_factor``
    (a (LU, pivots) pair for l1_kind "lu", pivots 0-based as SciPy and
    JAX give them), ``pou``, ``z_loc``, ``colids``, ``e_evecs``,
    ``e_eig_inv`` and ``x0`` (None where the preconditioner has none);
    ``meta``: the static fields named in PC_META."""
    missing = [k for k in PC_META if k not in meta]
    if missing:
        raise KeyError(f"pc_from_arrays: missing meta {missing}")
    batch = batch_from_arrays(d, device)
    dtype = batch.dtype

    def put(a, dt=dtype):
        if a is None:
            return None
        return torch.tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    if meta["l1_kind"] == "lu":
        lu, piv = d["l1_factor"]
        l1_factor = (put(lu), put(np.asarray(piv) + 1, torch.int32))
    else:
        l1_factor = put(d["l1_factor"])
    return GenEOPreconditioner(
        lvl1=str(meta["lvl1"]), lvl2=int(meta["lvl2"]),
        hybrid=bool(meta["hybrid"]), eff_hybrid=bool(meta["eff_hybrid"]),
        dim_e=int(meta["dim_e"]), k_max=int(meta["k_max"]),
        l1_kind=str(meta["l1_kind"]), batch=batch, l1_factor=l1_factor,
        pou=put(d.get("pou")), z_loc=put(d.get("z_loc")),
        colids=put(d.get("colids"), torch.int64),
        e_evecs=put(d.get("e_evecs")), e_eig_inv=put(d.get("e_eig_inv")),
        x0=put(d["x0"]))


def _dtype_of(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def bjacobi_from_arrays(d: dict, meta: dict, device
                        ) -> BlockJacobiPreconditioner:
    """``d``: the leaves ``factor``, ``pattern`` (None for the "exact"
    sub-type) and ``sizes`` as arrays; ``meta``: ``n_dof`` and
    ``sub_type``.  The dtype follows ``factor``."""
    factor = np.asarray(d["factor"])
    pattern = None if d["pattern"] is None else torch.tensor(
        np.asarray(d["pattern"]), device=device)
    return bjacobi_from_factors(
        int(meta["n_dof"]), str(meta["sub_type"]),
        torch.tensor(factor, dtype=_dtype_of(factor), device=device),
        pattern, np.asarray(d["sizes"]))


def mg_from_arrays(d: dict, meta: dict, device) -> MGPreconditioner:
    """``d``: the per-level leaves ``vals``, ``cols``, ``rows``,
    ``inv_diag`` and ``agg`` (sequences of arrays) and ``coarse_factor``;
    ``meta``: ``ns``, ``omega``, ``cycle_type``, ``smooth_down`` and
    ``smooth_up``.  The dtype follows ``coarse_factor``."""
    fac = np.asarray(d["coarse_factor"])
    levels = [tuple(np.asarray(x) for x in lv) for lv in
              zip(d["vals"], d["cols"], d["rows"], d["inv_diag"])]
    return mg_from_levels(
        levels, [np.asarray(a) for a in d["agg"]],
        torch.tensor(fac, dtype=_dtype_of(fac), device=device),
        [int(n) for n in meta["ns"]], omega=float(meta["omega"]),
        cycle_type=str(meta["cycle_type"]),
        smooth_down=int(meta["smooth_down"]),
        smooth_up=int(meta["smooth_up"]))


def _elastic_op_from(op, device):
    """A JAX LocalElastic or RobinOp (NumPy leaves) -> the port's."""
    from ..structured import elastic as el

    def put(a):
        return torch.tensor(np.asarray(a), dtype=_dtype_of(a), device=device)

    if hasattr(op, "border"):
        return el.RobinOp(dir_op=_elastic_op_from(op.dir_op, device),
                          neu_op=_elastic_op_from(op.neu_op, device),
                          border=put(op.border), optim=put(op.optim))
    return el.LocalElastic(cw=put(op.cw), k0=put(op.k0),
                           diag_add=put(op.diag_add),
                           pads=tuple(int(p) for p in op.pads))


def elastic_from_tree(pc, device):
    """The JAX package's ``ElasticGenEO`` with NumPy leaves (its pytree
    mapped through ``np.asarray``) -> the port's ``ElasticGenEO`` on
    ``device``: the same operator, level-1 PCG (surrogate FDM factors
    included) and coarse space.  The JAX package's [d, z, y, x, 3, k]
    basis becomes the port's [d, k, 3, z, y, x]."""
    from ..structured import elastic as el
    from ..structured import fdm, solvers

    def put(a):
        return None if a is None else torch.tensor(
            np.asarray(a), dtype=_dtype_of(a), device=device)

    sf = pc.l1.pre.fdm
    lx, ly, lz = (put(a) for a in sf.fac.lam)
    shift = put(sf.fac.shift)
    fac = fdm.FDMFactor(
        p=tuple(put(a) for a in sf.fac.p), lam=(lx, ly, lz), shift=shift,
        den=(lz[:, :, None, None] + ly[:, None, :, None]
             + lx[:, None, None, :] + shift).contiguous())
    pre = el.VecFDM(solvers.ScaledFDM(fac=fac, scale=put(sf.scale),
                                      maskf=put(sf.maskf)))
    l1 = solvers.PCGSolver(st=_elastic_op_from(pc.l1.st, device), pre=pre,
                           maskf=put(np.asarray(pc.l1.maskf)[..., 0]),
                           rtol=float(pc.l1.rtol), max_it=int(pc.l1.max_it),
                           reduce_dims=(-4, -3, -2, -1))
    gop = el.ElasticOp(e_cell=put(pc.gop.e_cell), k0=put(pc.gop.k0),
                       bc=put(pc.gop.bc),
                       grid_shape=tuple(int(v) for v in pc.gop.grid_shape))
    z = colids = col_sel = None
    if pc.z is not None:
        z = put(np.ascontiguousarray(
            np.transpose(np.asarray(pc.z), (0, 5, 4, 1, 2, 3))))
        cid = np.asarray(pc.colids, np.int64)
        colids = torch.tensor(cid, device=device)
        col_sel = torch.tensor(np.flatnonzero(cid.ravel() < pc.dim_e),
                               device=device)
    return el.ElasticGenEO(
        grid_shape=tuple(pc.grid_shape), dom_grid=tuple(pc.dom_grid),
        pad=tuple(pc.pad), local_shape=tuple(pc.local_shape),
        lvl1=str(pc.lvl1), lvl2=int(pc.lvl2), hybrid=bool(pc.hybrid),
        eff_hybrid=bool(pc.eff_hybrid), dim_e=int(pc.dim_e),
        k_max=int(pc.k_max), gop=gop, l1=l1, pou=put(pc.pou),
        maskf=put(pc.maskf), z=z, colids=colids, col_sel=col_sel,
        e_evecs=put(pc.e_evecs), e_eig_inv=put(pc.e_eig_inv),
        x0=put(pc.x0))
