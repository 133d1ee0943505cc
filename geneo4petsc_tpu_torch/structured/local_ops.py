"""Per-domain local operators in stencil form, built on the device.

The generic path materializes dense [n_dom, n_max, n_max] Neumann and
Dirichlet blocks (assembly/assemble.py).  Here each local operator is four
coefficient fields over the local box — diag + one off-diagonal per axis —
O(n_loc) memory, assembled from halo-gathered global fields.  Semantics
mirror the reference exactly:

* Neumann block = sum of member-element contributions weighted by
  1/elem_mult (the MatIS local block, geneo4PETSc.cpp:473-476 + 683-715);
  an edge is a member iff both endpoints lie in the dilated box, so edges
  leaving the box contribute NOTHING (the Neumann property).
* Dirichlet block = assembled global A restricted to the box
  (MatCreateSubMatrices, src/geneo.cpp:1697-1705): full assembled diagonal,
  off-diagonals kept only when the neighbour is inside the box.
* Robin = Dirichlet + optim * (border-restricted Neumann), border = nodes
  with multiplicity > 1 (createRobinMatrix, src/geneo.cpp:1613-1670).

Pad (out-of-grid) slots carry identity rows/cols — the module-wide inert
padding convention.

One layout: fields are [n_dom, lz, ly, lx]; a block of m vectors is
[n_dom, m, lz, ly, lx], the block axis next to the domain axis, so every
vector of the block is a contiguous brick and the stencil's shifted
slices stream along the fastest axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import halo
from .decompose import StructuredDecomposition
from .grid import _slices, derive_stencil_fields, raw_fields, stencil_apply


def lift(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [n_dom, lz, ly, lx] field viewed at the rank of x (a block
    [n_dom, m, lz, ly, lx] gets a unit block axis)."""
    return f.unsqueeze(1) if x.ndim == f.ndim + 1 else f


@dataclass(frozen=True)
class LocalStencil:
    """Batched local stencil operator.

    diag: [n_dom, lz, ly, lx]
    offs: tuple of 3 tensors, offs[a][..., v] = coefficient of the local
          edge (v, v + e_a) stored at v (0 where absent).  Off-diagonal
          VALUE of the operator (i.e. A[v, v+e_a]), not its negation.
    """

    diag: torch.Tensor
    offs: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Batched product: x [n_dom, lz, ly, lx] or [n_dom, m, lz, ly,
        lx]."""
        nd = x.ndim
        return stencil_apply(lift(self.diag, x),
                             tuple(lift(c, x) for c in self.offs), x,
                             (nd - 3, nd - 2, nd - 1))


_FIELDS = ("eoff", "ediag", "bcv", "diag", "mult", "emult", "mask")


@dataclass(frozen=True)
class LocalFields:
    """Halo-gathered per-domain raw fields ([n_dom, lz, ly, lx] each)."""

    eoff: tuple              # per-axis edge off-diagonal VALUE at v
    ediag: tuple             # per-axis edge diag add (both endpoints)
    bcv: torch.Tensor        # nodal Dirichlet-ghost diag add
    diag: torch.Tensor       # assembled global diagonal
    mult: torch.Tensor       # node multiplicity (float)
    emult: tuple             # per-axis edge multiplicity (float, 0 absent)
    mask: torch.Tensor       # bool: real grid node
    grid_shape: tuple
    dom_grid: tuple
    pad: tuple

    def map(self, fn, pad=None) -> "LocalFields":
        """Apply ``fn`` to every field tensor."""
        def one(v):
            return tuple(fn(t) for t in v) if isinstance(v, tuple) else fn(v)
        return LocalFields(**{k: one(getattr(self, k)) for k in _FIELDS},
                           grid_shape=self.grid_shape,
                           dom_grid=self.dom_grid,
                           pad=self.pad if pad is None else pad)


def gather_fields(sd: StructuredDecomposition, dtype=torch.float32,
                  pad=None, device="cuda") -> LocalFields:
    """Host fields -> halo-gathered local batches on ``device``.

    One f64 upload (kappa, or the explicit stencil fields); the stencil
    fields are derived there, the multiplicity fields are built from
    their 1-D profiles, everything is cast to ``dtype`` and gathered in
    one halo pass.  ``pad`` overrides the gather window (sd.pad + 1 for
    the dilated boxes of the coarse-operator assembly); the
    multiplicities are global and unaffected by it."""
    g = sd.grid
    pad = sd.pad if pad is None else tuple(pad)
    nx, ny, nz = g.shape
    raw_np, explicit = raw_fields(g, diag=False)
    raw = torch.tensor(raw_np, device=device)
    eoff, ediag, bcv, diag = derive_stencil_fields(
        raw, g.shape, 2 - (g.dim - 1), float(g.inp_eps), explicit)

    def prof(a):
        return torch.from_numpy(sd.axis_node_mult(a)).to(device, raw.dtype)

    def outer(fx, fy, fz):
        return fz[:, None, None] * fy[None, :, None] * fx[None, None, :]

    mults = [prof(a) for a in range(3)]
    mult = outer(*mults)
    emult = []
    for a in range(3):
        fs = list(mults)
        fs[a] = torch.from_numpy(sd.axis_edge_mult(a)).to(device, raw.dtype)
        emult.append(outer(*fs))
    ones = torch.ones((nz, ny, nx), dtype=dtype, device=device)
    stack = torch.stack([f.to(dtype) for f in
                         (*eoff, *ediag, bcv, diag, mult, *emult)] + [ones])
    b = halo.to_batch(halo.halo_gather(stack.reshape(13, -1), g.shape,
                                       sd.dom_grid, pad))
    parts = [b[:, i].contiguous() for i in range(13)]
    return LocalFields(eoff=tuple(parts[0:3]), ediag=tuple(parts[3:6]),
                       bcv=parts[6], diag=parts[7], mult=parts[8],
                       emult=tuple(parts[9:12]), mask=parts[12] > 0,
                       grid_shape=g.shape, dom_grid=sd.dom_grid, pad=pad)


def slice_inner(f: LocalFields, sd: StructuredDecomposition) -> LocalFields:
    """Fields gathered at sd.pad + 1 cut to the sd.pad window — one halo
    gather serves both geometries."""
    sl = (slice(None),) + tuple(slice(1, -1) if p else slice(None)
                                for p in (sd.pad[2], sd.pad[1], sd.pad[0]))
    return f.map(lambda t: t[sl].contiguous(), pad=sd.pad)


def _edge_ok(mask: torch.Tensor, a: int):
    """(lo_slice, hi_slice, both-endpoints-in-grid mask on the lo slice)."""
    lo, hi = _slices(mask.ndim, 3 - a)
    return lo, hi, mask[lo] & mask[hi]


def neumann_stencil(f: LocalFields) -> LocalStencil:
    """Weighted local Neumann operator (the MatIS local block)."""
    diag = torch.zeros_like(f.diag)
    offs = []
    for a in range(3):
        lo, hi, ok = _edge_ok(f.mask, a)
        if f.diag.shape[3 - a] == 1:
            offs.append(torch.zeros_like(f.diag))
            continue
        # edge element / its membership weight; emult >= 1 wherever the
        # edge exists (overlap >= 1 covers every edge)
        em = f.emult[a][lo]
        wgt = torch.where(ok & (em > 0), 1.0 / torch.clamp(em, min=1.0),
                          torch.zeros_like(em))
        off = torch.zeros_like(f.diag)
        off[lo] = wgt * f.eoff[a][lo]
        offs.append(off)
        cd = wgt * f.ediag[a][lo]
        diag[lo] += cd
        diag[hi] += cd
    # Dirichlet ghost elements: weight 1/node_mult (they belong to every
    # domain containing the node)
    diag = diag + f.bcv / torch.clamp(f.mult, min=1.0)
    diag = torch.where(f.mask, diag, torch.ones_like(diag))  # pad identity
    return LocalStencil(diag=diag, offs=tuple(offs))


def dirichlet_stencil(f: LocalFields) -> LocalStencil:
    """Assembled-A-restricted-to-box operator (the Dirichlet block)."""
    offs = []
    for a in range(3):
        lo, _hi, ok = _edge_ok(f.mask, a)
        off = torch.zeros_like(f.diag)
        if f.diag.shape[3 - a] > 1:
            off[lo] = torch.where(ok, f.eoff[a][lo],
                                  torch.zeros_like(off[lo]))
        offs.append(off)
    diag = torch.where(f.mask, f.diag, torch.ones_like(f.diag))
    return LocalStencil(diag=diag, offs=tuple(offs))


def robin_stencil(f: LocalFields, optim: float) -> LocalStencil:
    """Dirichlet + optim * border-restricted Neumann (ORAS/SORAS)."""
    neu = neumann_stencil(f)
    dir_ = dirichlet_stencil(f)
    border = (f.mult > 1.0) & f.mask
    zero = torch.zeros_like(f.diag)
    diag = dir_.diag + optim * torch.where(
        border, neu.diag - torch.where(f.mask, zero, zero + 1.0), zero)
    offs = []
    for a in range(3):
        lo, hi, _ = _edge_ok(f.mask, a)
        if f.diag.shape[3 - a] == 1:
            offs.append(dir_.offs[a])
            continue
        sel = torch.zeros_like(border)
        sel[lo] = border[lo] & border[hi]
        offs.append(dir_.offs[a] + optim * torch.where(sel, neu.offs[a],
                                                       zero))
    return LocalStencil(diag=diag, offs=tuple(offs))


# ---------------- plane-block form (block-tridiagonal factors) ------------

def plane_axis(local_shape) -> int:
    """Axis (0=x, 1=y, 2=z) used as the plane-sweep direction: the LONGEST
    local extent, so the plane size s2 (= product of the two others) — and
    with it the Schur factor footprint n_loc * s2 — is minimal."""
    return int(np.argmax(local_shape))


def _plane_order(axis: int) -> tuple:
    ax = 3 - axis
    return (0, ax) + tuple(i for i in (1, 2, 3) if i != ax)


def to_planes(x: torch.Tensor, axis: int) -> torch.Tensor:
    """[n_dom, lz, ly, lx(, k)] -> [n_dom, P, s2(, k)] with P = extent of
    `axis` and s2 = the flattened remaining two local axes."""
    order = _plane_order(axis) + tuple(range(4, x.ndim))
    xt = x.permute(order)
    return xt.reshape((xt.shape[0], xt.shape[1], -1) + x.shape[4:])


def from_planes(xp: torch.Tensor, axis: int, local_shape) -> torch.Tensor:
    """Inverse of to_planes."""
    sx, sy, sz = local_shape
    dims = {1: sz, 2: sy, 3: sx}          # local array axis -> extent
    order = _plane_order(axis)
    rest = [dims[i] for i in order[2:]]
    xt = xp.reshape(xp.shape[:2] + tuple(rest) + xp.shape[3:])
    inv = tuple(int(i) for i in np.argsort(np.asarray(order)))
    return xt.permute(inv + tuple(range(4, xt.ndim)))


def plane_coefficients(st: LocalStencil, axis: int):
    """Stencil -> (diag_p [n_dom, P, s2], in-plane offs [(tensors,
    strides)], inter-plane coupling c [n_dom, P-1, s2]).

    In-plane offsets are returned as (coeff [n_dom, P, s2], stride) pairs:
    coeff[..., r] couples plane slot r with r + stride (zero where the
    edge wraps a row or is absent)."""
    local = st.diag.shape[1:]                    # (lz, ly, lx)
    dims_xyz = (local[2], local[1], local[0])    # extents per x/y/z axis
    diag_p = to_planes(st.diag, axis)
    # the two non-plane axes in the order they appear inside a plane
    # (to_planes keeps the remaining local axes in (z, y, x) order); the
    # fastest-varying axis inside the flattened plane is the LAST one
    rest_axes = [a for a in (2, 1, 0) if a != axis]
    strides = {}
    stride = 1
    for a in reversed(rest_axes):
        strides[a] = stride
        stride *= dims_xyz[a]
    inplane = [(to_planes(st.offs[a], axis), strides[a]) for a in rest_axes]
    c = to_planes(st.offs[axis], axis)[:, :-1]   # last plane zero
    return diag_p, inplane, c
