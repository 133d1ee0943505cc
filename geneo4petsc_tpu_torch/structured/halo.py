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


# ---------------- one rank's z-layers (the rank-split layout) ----------------

def _side(grid_shape, dom_grid, pad):
    """halo_gather's arguments for pad_z planes beside a rank's layers:
    one layer of bricks pad_z thick, extended in x and y only."""
    nx, ny, _nz = grid_shape
    gx, gy, _gz = dom_grid
    return (nx, ny, pad[2]), (gx, gy, 1), (pad[0], pad[1], 0)


def window_gather(xw: torch.Tensor, grid_shape, dom_grid, pad,
                  n_layers: int, sides=(True, True)) -> torch.Tensor:
    """halo_gather of the z-layers of one rank.  ``xw`` [(k,) planes]
    holds the planes of ``n_layers`` consecutive domain layers and, on
    each side where ``sides`` says so, pad_z planes beside them (a side
    without them is the grid's end); returns their boxes [n_layers, gy,
    gx, (k,) lz, ly, lx] as halo_gather of the whole grid does:
    halo_gather of the layers, whose outer z-halos are then read from the
    side planes."""
    nx, ny, nz = grid_shape
    gx, gy, gz = dom_grid
    iz, pz, plane = nz // gz, pad[2], nx * ny
    lo = pz if sides[0] else 0
    b = halo_gather(xw.narrow(-1, lo * plane, n_layers * iz * plane),
                    (nx, ny, n_layers * iz), (gx, gy, n_layers), pad)
    if pz and any(sides):
        # b is a fresh tensor here (the z-extension concatenates)
        laxis, side = 2 + xw.ndim, _side(grid_shape, dom_grid, pad)
        lz = b.shape[laxis]
        if sides[0]:
            b.narrow(0, 0, 1).narrow(laxis, 0, pz).copy_(
                halo_gather(xw.narrow(-1, 0, pz * plane), *side))
        if sides[1]:
            b.narrow(0, n_layers - 1, 1).narrow(laxis, lz - pz, pz).copy_(
                halo_gather(xw.narrow(-1, (lo + n_layers * iz) * plane,
                                      pz * plane), *side))
    return b


def window_fold(xl: torch.Tensor, grid_shape, dom_grid, pad,
                sides=(True, True)) -> torch.Tensor:
    """Adjoint of window_gather: boxes [n_layers, gy, gx, (k,) lz, ly, lx]
    -> the planes [(k,) planes] of the layers and, where ``sides`` says
    so, pad_z planes beside them: halo_scatter_add of the layers (so that
    on a whole grid it is halo_scatter_add bit for bit), beside the outer
    z-halos folded in x and y (dropped at the grid's ends)."""
    nx, ny, nz = grid_shape
    gx, gy, gz = dom_grid
    n_layers, pz = xl.shape[0], pad[2]
    core = halo_scatter_add(xl, (nx, ny, n_layers * nz // gz),
                            (gx, gy, n_layers), pad)
    if not (pz and any(sides)):
        return core
    laxis, side = xl.ndim - 3, _side(grid_shape, dom_grid, pad)
    lz = xl.shape[laxis]
    parts = [core]
    if sides[0]:
        parts.insert(0, halo_scatter_add(
            xl.narrow(0, 0, 1).narrow(laxis, 0, pz), *side))
    if sides[1]:
        parts.append(halo_scatter_add(
            xl.narrow(0, n_layers - 1, 1).narrow(laxis, lz - pz, pz), *side))
    return torch.cat(parts, dim=-1)
