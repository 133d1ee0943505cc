"""One iteration of the structured PCG local solver
(``structured/solvers.py`` ``PCGSolver``) on a 7-point ``LocalStencil``
as three passes around the preconditioner's solve:

* ``pcg_matvec``: beta = rz / rz_prev (0 where rz_prev <= 0) from the
  r.z partials, p_new = z + beta p (on the first iteration p_new = p),
  w = (A p_new) * mask, and the p.w partials;
* ``pcg_update``: alpha = rz / pw (0 where pw <= 0) from the partials,
  u += alpha p and r -= alpha w in place, rz_prev = rz, and the r.r
  partials;
* ``pcg_dot``: the r.z partials of r and z = pre.solve(r).

Vectors are contiguous [n_dom, lz, ly, lx] or blocks [n_dom, m, lz, ly,
lx]; each box (and block column) is a system of its own.  A partials
tensor is [n_sys, n] and a system's scalar is the sum of its row.  For
CPU tensors each wrapper computes its plain version (torch ops, the
whole sum in column 0); for CUDA tensors it launches the kernel of
``csrc/pcg_fused.cu`` (built at first use by ``ops/_build.py``) and never
falls back.  The plain versions also take any operator with a
``matvec`` and systems of any number of trailing axes (``axes``), and
``PCGSolver.step`` is made of them.  ``pcg_matvec.launches``,
``pcg_update.launches`` and ``pcg_dot.launches`` count kernel launches.
While a profiler records, each launch runs inside a host op named
``pcg_fused.<kernel>``, so that the profiler links the kernel to the op
and to the ranges around it, as it links a torch op's kernels.
``Workspace`` holds the buffers of one solve and picks its passes.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import torch

from . import _build

THREADS = 256           # threads a block (csrc/pcg_fused.cu kThreads)
PER_THREAD = 8          # elements a thread of update and dot (kPer)
TILE_POINTS = 2         # tile points a thread of pcg_matvec (kPts)
Z_CHUNK = 8             # planes a block of pcg_matvec marches at most
_MAX_GRID_Y = 65535     # CUDA's limit on gridDim.y


@dataclass(frozen=True)
class Plan:
    """The launch geometry of a vector shape: systems, box, pcg_matvec's
    in-plane tile (ty rows by sx columns) and z-chunk (zc planes), and the
    partials a system of each pass (``n_mv`` for pcg_matvec, ``n_el`` for
    pcg_update and pcg_dot; 1 on the CPU)."""

    n_sys: int
    m: int
    box: tuple          # (lz, ly, lx)
    ty: int
    sx: int
    zc: int
    n_mv: int
    n_el: int


def plan(shape, device) -> Plan:
    """The plan of vectors of ``shape`` on ``device``."""
    if len(shape) not in (4, 5):
        raise ValueError(f"pcg_fused: vectors are [n_dom, (m,) lz, ly, lx],"
                         f" got {tuple(shape)}")
    m = int(shape[1]) if len(shape) == 5 else 1
    lz, ly, lx = (int(s) for s in shape[-3:])
    n_sys = int(shape[0]) * m
    if torch.device(device).type != "cuda":
        return Plan(n_sys, m, (lz, ly, lx), ly, lx, lz, 1, 1)
    pts = TILE_POINTS * THREADS
    sx = min(lx, pts)
    ty = max(1, min(ly, pts // sx))
    zc = -(-lz // -(-lz // Z_CHUNK))
    n_mv = -(-ly // ty) * -(-lx // sx) * -(-lz // zc)
    n_el = -(-(lz * ly * lx) // (THREADS * PER_THREAD))
    return Plan(n_sys, m, (lz, ly, lx), ty, sx, zc, n_mv, n_el)


def _sys_sum(parts: torch.Tensor) -> torch.Tensor:
    return parts.sum(1)


def _guarded(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (PCGSolver's alpha and beta)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                       torch.zeros_like(den))


def _per_sys(s: torch.Tensor, v: torch.Tensor, axes: int) -> torch.Tensor:
    """[n_sys] scalars viewed against vectors like ``v`` (systems of
    ``axes`` trailing axes)."""
    return s.reshape(v.shape[:v.ndim - axes] + (1,) * axes)


def _dots(u: torch.Tensor, v: torch.Tensor, axes: int) -> torch.Tensor:
    """[n_sys] dot products (PCGSolver._dots' sum)."""
    return (u * v).sum(dim=tuple(range(-axes, 0)),
                       keepdim=True).reshape(-1)


def _put(parts: torch.Tensor, sums: torch.Tensor) -> None:
    parts.zero_()
    parts[:, 0] = sums


def _lift(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """structured.local_ops.lift: a field viewed at the rank of ``v``."""
    return f.unsqueeze(1) if v.ndim == f.ndim + 1 else f


def pcg_direction_plain(z, p, p_new, rz_parts, rz_prev,
                        axes: int = 3) -> None:
    """p_new = z + beta p, beta from the r.z partials and rz_prev."""
    beta = _guarded(_sys_sum(rz_parts), rz_prev)
    torch.add(z, _per_sys(beta, p, axes) * p, out=p_new)


def pcg_product_plain(st, mask, p, w, pw_parts, axes: int = 3) -> None:
    """w = (A p) * mask and the p.w partials."""
    w.copy_(st.matvec(p) * _lift(mask, p))
    _put(pw_parts, _dots(p, w, axes))


def pcg_matvec_plain(st, mask, z, p, p_new, w, rz_parts, rz_prev,
                     pw_parts, first: bool, axes: int = 3) -> None:
    """Plain version of ``pcg_matvec``."""
    if first:
        p_new.copy_(p)
    else:
        pcg_direction_plain(z, p, p_new, rz_parts, rz_prev, axes)
    pcg_product_plain(st, mask, p_new, w, pw_parts, axes)


def pcg_update_plain(u, r, p, w, pw_parts, rz_parts, rz_prev, rr_parts,
                     axes: int = 3) -> None:
    """Plain version of ``pcg_update``."""
    rz = _sys_sum(rz_parts)
    alpha = _per_sys(_guarded(rz, _sys_sum(pw_parts)), p, axes)
    rz_prev.copy_(rz)
    u.add_(alpha * p)
    r.sub_(alpha * w)
    _put(rr_parts, _dots(r, r, axes))


def pcg_dot_plain(r, z, rz_parts, axes: int = 3) -> None:
    """Plain version of ``pcg_dot``."""
    _put(rz_parts, _dots(r, z, axes))


def _check(what: str, vectors, fields=(), parts=(), scalars=()) -> None:
    """Every tensor on one device, of one floating dtype, contiguous;
    vectors of one shape, fields [n_dom, lz, ly, lx] of it, partials
    [n_sys, n], scalars [n_sys] (the launch checks n)."""
    v0 = vectors[0]
    if v0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {v0.dtype} not supported (float64 "
                        "or float32)")
    if v0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {v0.device}")
    pl = plan(v0.shape, "cpu")
    for t in (*vectors, *fields, *parts, *scalars):
        if t.device != v0.device or t.dtype != v0.dtype:
            raise ValueError(f"{what}: tensors on {v0.device} in {v0.dtype}"
                             f" meet one on {t.device} in {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for t in vectors:
        if t.shape != v0.shape:
            raise ValueError(f"{what}: vectors of shapes {tuple(v0.shape)} "
                             f"and {tuple(t.shape)}")
    fshape = (v0.shape[0],) + tuple(v0.shape[-3:])
    for t in fields:
        if tuple(t.shape) != fshape:
            raise ValueError(f"{what}: fields must be {fshape}, got "
                             f"{tuple(t.shape)}")
    for t in parts:
        if t.ndim != 2 or t.shape[0] != pl.n_sys or t.shape[1] < 1:
            raise ValueError(f"{what}: partials must be [{pl.n_sys}, n], "
                             f"got {tuple(t.shape)}")
    for t in scalars:
        if tuple(t.shape) != (pl.n_sys,):
            raise ValueError(f"{what}: scalars must be [{pl.n_sys}], got "
                             f"{tuple(t.shape)}")


def _want(what: str, parts: torch.Tensor, n: int) -> None:
    if parts.shape[1] != n:
        raise ValueError(f"{what}: the launch writes {n} partials a "
                         f"system, the tensor holds {parts.shape[1]}")


def _host_op(name: str):
    """A host op ``pcg_fused.<name>`` around a launch while a profiler
    records (the kernel is launched through ctypes, outside any torch
    op); nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast("pcg_fused." + name)
    return contextlib.nullcontext()


def _raise_on(what: str, err: int, grid) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (grid {grid[0]}x"
                           f"{grid[1]}, {THREADS} threads)")


def pcg_matvec(st, mask, z, p, p_new, w, rz_parts, rz_prev, pw_parts,
               first: bool) -> None:
    """p_new = z + beta p (p on the ``first`` iteration), w = (A p_new) *
    mask and the p.w partials, for ``st`` a LocalStencil and ``mask`` its
    float mask; beta from the r.z partials and rz_prev."""
    _check("pcg_matvec", (z, p, p_new, w), (mask, st.diag, *st.offs),
           (rz_parts, pw_parts), (rz_prev,))
    if p.device.type == "cpu":
        pcg_matvec_plain(st, mask, z, p, p_new, w, rz_parts, rz_prev,
                         pw_parts, first)
        return
    pl = plan(p.shape, p.device)
    _want("pcg_matvec", pw_parts, pl.n_mv)
    _want("pcg_matvec", rz_parts, pl.n_el)
    if pl.n_sys == 0:
        return
    grid = (pl.n_mv, min(pl.n_sys, _MAX_GRID_Y))
    cx, cy, cz = st.offs
    with torch.cuda.device(p.device), _host_op("pcg_matvec"):
        err = _build.load().g4p_pcg_matvec(
            (p if first else z).data_ptr(), p.data_ptr(), p_new.data_ptr(),
            w.data_ptr(), st.diag.data_ptr(), cx.data_ptr(), cy.data_ptr(),
            cz.data_ptr(), mask.data_ptr(), rz_parts.data_ptr(),
            rz_prev.data_ptr(), pw_parts.data_ptr(), pl.n_sys, pl.m,
            *pl.box, pl.zc, pl.ty, pl.sx, pl.n_el, int(bool(first)),
            int(p.dtype == torch.float64), *grid,
            torch.cuda.current_stream().cuda_stream)
    pcg_matvec.launches += 1
    _raise_on("pcg_matvec", err, grid)


def pcg_update(u, r, p, w, pw_parts, rz_parts, rz_prev, rr_parts) -> None:
    """alpha from the partials; u += alpha p, r -= alpha w in place;
    rz_prev = rz; the r.r partials."""
    _check("pcg_update", (u, r, p, w), (), (pw_parts, rz_parts, rr_parts),
           (rz_prev,))
    if p.device.type == "cpu":
        pcg_update_plain(u, r, p, w, pw_parts, rz_parts, rz_prev, rr_parts)
        return
    pl = plan(p.shape, p.device)
    _want("pcg_update", pw_parts, pl.n_mv)
    _want("pcg_update", rz_parts, pl.n_el)
    _want("pcg_update", rr_parts, pl.n_el)
    if pl.n_sys == 0:
        return
    grid = (pl.n_el, min(pl.n_sys, _MAX_GRID_Y))
    with torch.cuda.device(p.device), _host_op("pcg_update"):
        err = _build.load().g4p_pcg_update(
            u.data_ptr(), r.data_ptr(), p.data_ptr(), w.data_ptr(),
            pw_parts.data_ptr(), pl.n_mv, rz_parts.data_ptr(), pl.n_el,
            rz_prev.data_ptr(), rr_parts.data_ptr(), pl.n_sys,
            math.prod(pl.box), int(p.dtype == torch.float64), *grid,
            torch.cuda.current_stream().cuda_stream)
    pcg_update.launches += 1
    _raise_on("pcg_update", err, grid)


def pcg_dot(r, z, rz_parts) -> None:
    """The r.z partials."""
    _check("pcg_dot", (r, z), (), (rz_parts,))
    if r.device.type == "cpu":
        pcg_dot_plain(r, z, rz_parts)
        return
    pl = plan(r.shape, r.device)
    _want("pcg_dot", rz_parts, pl.n_el)
    if pl.n_sys == 0:
        return
    grid = (pl.n_el, min(pl.n_sys, _MAX_GRID_Y))
    with torch.cuda.device(r.device), _host_op("pcg_dot"):
        err = _build.load().g4p_pcg_dot(
            r.data_ptr(), z.data_ptr(), rz_parts.data_ptr(), pl.n_sys,
            math.prod(pl.box), int(r.dtype == torch.float64), *grid,
            torch.cuda.current_stream().cuda_stream)
    pcg_dot.launches += 1
    _raise_on("pcg_dot", err, grid)


pcg_matvec.launches = 0
pcg_update.launches = 0
pcg_dot.launches = 0


class Workspace:
    """The buffers of one PCG solve of the right-hand side block ``b``
    on ``st`` with the float mask ``mask``, and its three passes: those
    above for ``st`` a LocalStencil (``axes`` None), or their plain
    versions for any operator with a ``matvec`` whose systems are the
    ``axes`` trailing axes of ``b``.  Buffers: w, a spare direction
    (p_new cannot overwrite the p that other blocks read as their
    neighbours, so two directions alternate; the first is the
    preconditioner's output), the partials and rz_prev.  Beside the
    solve's u, r and the current p it holds two vectors, w and the
    spare."""

    def __init__(self, st, mask: torch.Tensor, b: torch.Tensor,
                 axes: int | None = None):
        self.st, self.mask = st, mask
        if axes is None:
            pl = plan(b.shape, b.device)
            n_sys, n_mv, n_el = pl.n_sys, pl.n_mv, pl.n_el
            self._passes = (pcg_matvec, pcg_update, pcg_dot)
        else:
            n_sys = b.numel() // max(math.prod(b.shape[b.ndim - axes:]), 1)
            n_mv = n_el = 1
            self._passes = tuple(functools.partial(f, axes=axes) for f in (
                pcg_matvec_plain, pcg_update_plain, pcg_dot_plain))
        self.w = torch.empty_like(b)
        self.spare = torch.empty_like(b)
        self.pw = b.new_empty((n_sys, n_mv))
        self.rz = b.new_empty((n_sys, n_el))
        self.rr = b.new_empty((n_sys, n_el))
        self.rz_prev = b.new_empty((n_sys,))

    def dot(self, r: torch.Tensor, z: torch.Tensor) -> None:
        self._passes[2](r, z, self.rz)

    def matvec(self, z: torch.Tensor, p: torch.Tensor,
               first: bool) -> torch.Tensor:
        """The new direction (in the spare buffer; ``p`` becomes the
        spare); w is left in ``self.w``."""
        p_new = self.spare
        self._passes[0](self.st, self.mask, z, p, p_new, self.w, self.rz,
                        self.rz_prev, self.pw, first)
        self.spare = p
        return p_new

    def update(self, u: torch.Tensor, r: torch.Tensor,
               p: torch.Tensor) -> None:
        self._passes[1](u, r, p, self.w, self.pw, self.rz, self.rz_prev,
                        self.rr)

    def rr_sums(self) -> torch.Tensor:
        """[n_sys] r.r of the last update."""
        return _sys_sum(self.rr)
