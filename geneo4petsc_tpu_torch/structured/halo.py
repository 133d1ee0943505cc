"""Structured halo exchange: global grid vector <-> overlapped local boxes.

On a box decomposition the gather/scatter of the generic path is pure
structured data movement: reshape the grid into domain bricks, then pull
each brick's halo layers from its face/edge/corner neighbours with static
shifts — the analogue of the reference's VecScatter forward/reverse
(src/geneo.cpp:1845-1900), with no index arrays.

``halo_scatter_add`` is written out as the exact reverse of
``halo_gather``: the halo layers are added back onto the neighbours they
came from with shifted-slice adds, axis by axis in reverse order.  No
``index_add_``/``scatter_add_``: their CUDA atomics would make float sums
depend on the order of arrival, so repeated applies would differ in bits.

Layout: global vectors are [nz, ny, nx] (x fastest), flat [n] or with a
leading block axis [k, n]; local batches are [gz, gy, gx, (k,) lz, ly, lx]
("block-grid" form), flattened by ``to_batch`` to [n_dom, (k,) lz, ly, lx]
with d = px + gx*(py + gy*pz).
"""

from __future__ import annotations

import torch


def _extend_axis(blocks: torch.Tensor, gaxis: int, laxis: int, pad: int
                 ) -> torch.Tensor:
    """Grow the local axis `laxis` by `pad` layers on both sides, pulling
    the data from the neighbouring blocks along grid axis `gaxis` (zeros
    at the outer boundary)."""
    if pad == 0:
        return blocks
    g = blocks.shape[gaxis]
    n = blocks.shape[laxis]
    zeros = torch.zeros_like(blocks.narrow(gaxis, 0, 1).narrow(laxis, 0, pad))
    lo = torch.cat([zeros, blocks.narrow(gaxis, 0, g - 1)
                    .narrow(laxis, n - pad, pad)], dim=gaxis)
    hi = torch.cat([blocks.narrow(gaxis, 1, g - 1).narrow(laxis, 0, pad),
                    zeros], dim=gaxis)
    return torch.cat([lo, blocks, hi], dim=laxis)


def _fold_axis(ext: torch.Tensor, gaxis: int, laxis: int, pad: int
               ) -> torch.Tensor:
    """Adjoint of _extend_axis: the core layers, plus each block's halo
    layers added onto the neighbour they were read from."""
    if pad == 0:
        return ext
    g = ext.shape[gaxis]
    n = ext.shape[laxis] - 2 * pad
    out = ext.narrow(laxis, pad, n).clone()
    if g > 1:
        # the lower halo of block p held block p-1's last layers
        out.narrow(gaxis, 0, g - 1).narrow(laxis, n - pad, pad).add_(
            ext.narrow(gaxis, 1, g - 1).narrow(laxis, 0, pad))
        # the upper halo of block p held block p+1's first layers
        out.narrow(gaxis, 1, g - 1).narrow(laxis, 0, pad).add_(
            ext.narrow(gaxis, 0, g - 1).narrow(laxis, n + pad, pad))
    return out


def _axes(x_block: bool):
    """(gaxis, laxis) of x, y, z in the block-grid layout."""
    off = 1 if x_block else 0
    return ((2, 5 + off), (1, 4 + off), (0, 3 + off))


def halo_gather(x: torch.Tensor, grid_shape, dom_grid, pad) -> torch.Tensor:
    """[n] (or [k, n]) -> block-grid local boxes
    [gz, gy, gx, (k,) lz, ly, lx] including `pad` halo layers per divided
    axis.  Out-of-grid halo slots read 0 (the generic dump-slot
    convention).  VecScatter forward/INSERT."""
    nx, ny, nz = grid_shape
    gx, gy, gz = dom_grid
    lead = x.shape[:-1]              # optional block axis
    b = x.reshape(lead + (gz, nz // gz, gy, ny // gy, gx, nx // gx))
    k = len(lead)
    # -> [gz, gy, gx, (k,) iz, iy, ix]
    b = b.permute(k, k + 2, k + 4, *range(k), k + 1, k + 3, k + 5)
    # grow halos axis by axis; corners compose automatically because each
    # extension operates on the already-extended neighbour data
    for (gaxis, laxis), p in zip(_axes(bool(k)), pad):
        b = _extend_axis(b, gaxis, laxis, p)
    return b


def halo_scatter_add(xl: torch.Tensor, grid_shape, dom_grid, pad
                     ) -> torch.Tensor:
    """Adjoint of halo_gather: overlapped block-grid boxes -> global sum
    [n] (or [k, n]).  VecScatter reverse/ADD, in a fixed order."""
    nx, ny, nz = grid_shape
    k = xl.ndim - 6
    b = xl
    for (gaxis, laxis), p in reversed(list(zip(_axes(bool(k)), pad))):
        b = _fold_axis(b, gaxis, laxis, p)
    # [gz, gy, gx, (k,) iz, iy, ix] -> [(k,) gz, iz, gy, iy, gx, ix]
    b = b.permute(*range(3, 3 + k), 0, 3 + k, 1, 4 + k, 2, 5 + k)
    return b.reshape(xl.shape[3:3 + k] + (nx * ny * nz,))


def to_batch(b: torch.Tensor) -> torch.Tensor:
    """Block-grid [gz, gy, gx, ...] -> [n_dom, ...]."""
    return b.reshape((-1,) + b.shape[3:])


def from_batch(xb: torch.Tensor, dom_grid) -> torch.Tensor:
    gx, gy, gz = dom_grid
    return xb.reshape((gz, gy, gx) + xb.shape[1:])
