"""Block-layout iteration: run the inner Krylov loop in domain-brick order
so that the per-iteration preconditioner apply needs no global <-> brick
permutes.

The halo gather/scatter of the global layout (halo.py) pay a 6-D
permute between the global [nz, ny, nx] vector and the [gz, gy, gx, iz,
iy, ix] bricks on every call; the halo extension itself moves only the
pad layers.  The permute is a pure reordering, so running the whole
inner Krylov loop on block-major flat vectors makes it loop-invariant:
the residual is permuted into brick order once per inner solve and the
correction back once, and no permute runs inside an iteration.  PETSc
vectors are distribution-native, so the reference has no analogue; its
VecScatter contexts are likewise built once (src/geneo.cpp:1845-1900).

The operators are the global layout's, bit for bit:

  * matvec  = the assembled stencil on 1-layer-dilated bricks, read at
    each brick's core: the same per-node products added in the same
    order as GlobalStencil.matvec;
  * level 1 = brick halo extension by ``pad`` -> the same batched local
    solve (StructuredGenEO.l1_local) -> fold, the extension's adjoint;
  * level 2 = the same Z / E factors (StructuredGenEO.coarse_local)
    between extension and fold.

Single-process only, as in the JAX package: the rank-split layout
(sharded.py) keeps z-slab vectors.  The elastic backend has no block
layout there either.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import halo
from . import local_ops as lo
from .decompose import StructuredDecomposition
from .geneo import LocalSchwarz, StructuredGenEO


def extend_blocks(b: torch.Tensor, pad) -> torch.Tensor:
    """Grow bricks [gz, gy, gx, iz, iy, ix] by ``pad`` = (px, py, pz)
    halo layers per axis, moving only the pad layers (zeros at the grid
    boundary): halo_gather's extension stage."""
    for (gaxis, laxis), p in zip(halo._axes(False), pad):
        b = halo._extend_axis(b, gaxis, laxis, p)
    return b


def fold_blocks(xe: torch.Tensor, pad) -> torch.Tensor:
    """Adjoint of extend_blocks: each brick's halo layers added back onto
    the neighbour they were read from, axis by axis in reverse order
    (halo_scatter_add's fold stage; needs inner >= 2 * pad on every
    divided axis, which build_block_mode checks)."""
    for (gaxis, laxis), p in reversed(list(zip(halo._axes(False), pad))):
        xe = halo._fold_axis(xe, gaxis, laxis, p)
    return xe


def to_block_order(x: torch.Tensor, grid_shape, dom_grid) -> torch.Tensor:
    """Global flat [n] -> bricks [gz, gy, gx, iz, iy, ix]: the one
    permute, paid per inner solve."""
    return halo.halo_gather(x, grid_shape, dom_grid, (0, 0, 0))


def from_block_order(b: torch.Tensor, grid_shape) -> torch.Tensor:
    """Inverse of to_block_order (a pure permutation)."""
    nx, ny, nz = grid_shape
    return b.permute(0, 3, 1, 4, 2, 5).reshape(nx * ny * nz)


def _window(t: torch.Tensor, ax: int = 0, off: int = 0) -> torch.Tensor:
    """The core of a 1-dilated [n_dom, z, y, x] array, shifted by ``off``
    along array axis ``ax``."""
    idx = [slice(None)] * 4
    for a in (1, 2, 3):
        o = off if a == ax else 0
        idx[a] = slice(1 + o, t.shape[a] - 1 + o)
    return t[tuple(idx)]


@dataclass(frozen=True)
class BlockGenEO(LocalSchwarz):
    """StructuredGenEO on block-major flat vectors.

    ``diag``: the assembled diagonal at each brick's core; ``up[a]`` /
    ``down[a]``: the coupling A[v, v + e_a] at v and A[v, v - e_a]
    (stored at v - e_a) over the core, for a in (x, y, z) — the
    Dirichlet-restriction stencil of the 1-dilated non-overlapping
    bricks, whose core rows are complete rows of A."""

    pc: StructuredGenEO
    diag: torch.Tensor
    up: tuple
    down: tuple

    # ---------------- layout plumbing ----------------
    @property
    def _shape6(self):
        gx, gy, gz = self.pc.dom_grid
        nx, ny, nz = self.pc.grid_shape
        return (gz, gy, gx, nz // gz, ny // gy, nx // gx)

    def _unflat(self, xf: torch.Tensor) -> torch.Tensor:
        return xf.reshape(self._shape6)

    def to_block(self, x: torch.Tensor) -> torch.Tensor:
        return to_block_order(x, self.pc.grid_shape,
                              self.pc.dom_grid).reshape(-1)

    def from_block(self, xf: torch.Tensor) -> torch.Tensor:
        return from_block_order(self._unflat(xf), self.pc.grid_shape)

    def _gather(self, xf: torch.Tensor) -> torch.Tensor:
        return halo.to_batch(extend_blocks(self._unflat(xf), self.pc.pad))

    def _scatter(self, ub: torch.Tensor) -> torch.Tensor:
        return fold_blocks(halo.from_batch(ub, self.pc.dom_grid),
                           self.pc.pad).reshape(-1)

    # ---------------- the set-up preconditioner ----------------
    lvl2 = property(lambda self: self.pc.lvl2)
    hybrid = property(lambda self: self.pc.hybrid)
    eff_hybrid = property(lambda self: self.pc.eff_hybrid)
    l1_exact = property(lambda self: self.pc.l1_exact)

    def coarse_local(self, xb, coarse_w=None):
        return self.pc.coarse_local(xb, coarse_w)

    def l1_local(self, xb):
        return self.pc.l1_local(xb)

    # ---------------- operators (flat block-major vectors) ----------------
    def matvec(self, xf: torch.Tensor) -> torch.Tensor:
        """Global SpMV in brick order: extend one layer on every axis,
        then the 7-point product as shifted core windows of the extended
        bricks, per node diag x, then per axis (x, y, z) the upper and
        the lower neighbour — GlobalStencil.matvec's order."""
        xe = halo.to_batch(extend_blocks(self._unflat(xf), (1, 1, 1)))
        y = self.diag * _window(xe)
        for a in range(3):
            ax = 3 - a                  # array axis of stencil axis a
            y.addcmul_(self.up[a], _window(xe, ax, +1))
            y.addcmul_(self.down[a], _window(xe, ax, -1))
        return y.reshape(-1)


def build_block_mode(pc: StructuredGenEO, sd: StructuredDecomposition,
                     dtype=torch.float32, device=None) -> BlockGenEO:
    """Assemble the 1-dilated brick stencil and wrap the preconditioner;
    every factor (level 1, Z, E) is shared with ``pc``."""
    for a in range(3):
        if sd.dom_grid[a] > 1 and sd.inner[a] < 2 * sd.pad[a]:
            raise ValueError(
                "block layout requires inner >= 2*overlap per divided "
                f"axis (axis {a}: inner {sd.inner[a]}, pad {sd.pad[a]})")
    device = pc.maskf.device if device is None else device
    # the Dirichlet stencil on a 1-layer window on every axis (zero
    # couplings on non-divided axes and out of the grid)
    st = lo.dirichlet_stencil(lo.gather_fields(sd, dtype=dtype,
                                               pad=(1, 1, 1),
                                               device=device))
    up = tuple(_window(c).contiguous() for c in st.offs)
    down = tuple(_window(c, 3 - a, -1).contiguous()
                 for a, c in enumerate(st.offs))
    return BlockGenEO(pc=pc, diag=_window(st.diag).contiguous(), up=up,
                      down=down)
