"""Multi-rank structured GenEO: z-slab vectors, plane exchanges written out.

Layout (the JAX package's structured/sharded.py): global vectors are
[nz, ny, nx] with z slowest (flat [n], or node-major [3n] for the
elastic backend) and the subdomain batch is z-major (d = px + gx*(py +
gy*pz)).  Rank r of D owns

  * planes [r*nz/D, (r+1)*nz/D) of every global vector and field,
  * domains [r*n_dom/D, (r+1)*n_dom/D) of the batch,
  * a replicated copy of E's factor (and of the per-cell modulus field of
    the elastic backend).

The JAX package leaves the communication to XLA's SPMD partitioner.  Here
it is a static plan built on the host at setup (``PlanePlan``): each rank
needs the contiguous window of planes that its domains' overlapped boxes
touch, and the plan says which planes come from which rank.  Per
iteration:

  * halo gather: point-to-point sends bring the window's planes from
    the ranks that own them,
    then the boxes of the rank's z-layers are cut from it
    (halo.window_gather);
  * scatter-add: its exact reverse (halo.window_fold, then the plane
    contributions back to their owners through the same exchange), added
    in rank order with no atomics, as halo.py's rule for sums;
  * global operator: the same plan with one plane each side (``SlabOp``);
  * dot products and norms: local partials and an ``all_reduce``
    (krylov.common.DistInner); the coarse Z^T x: an ``all_reduce`` of the
    [dim_e] vector;
  * the inexact level-1 PCG advances until the worst domain of every rank
    has converged, as one batch does on one process.

On one rank every sum is the single-process sum bit for bit.
Constraints, as in the JAX package: nz % D == 0 and n_dom % D == 0.  A
rank's domains need not fill whole z-layers (gz % D != 0, e.g. 4x4x4
boxes on 8 ranks): its window then spans the layers it shares.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..krylov.common import DistInner
from ..parallel.multiproc import Ranks
from . import halo
from .block_tridiag import BlockTridiagFactor
from .geneo import LocalSchwarz
from .solvers import PCGSolver


class PlanePlan:
    """Static exchange of z-planes (each ``plane`` values long) between
    the ranks: rank r owns planes ``own[r]`` = [lo, hi) and reads the
    window ``want[r]``, which may reach outside [0, nz) (those planes read
    zero and their contributions are dropped).  ``below`` / ``above``:
    the window's planes under 0 / over nz."""

    def __init__(self, nz: int, plane: int, own, want, ranks: Ranks):
        r = ranks.rank
        self.ranks = ranks
        self.plane = plane
        self.own = own[r]
        lo, hi = want[r]
        self.below = max(0, -lo)                 # zero planes under 0
        self.above = max(0, hi - nz)             # zero planes over nz

        def overlap(a, b):
            return max(a[0], b[0]), min(a[1], b[1])

        def clip(w):
            return max(w[0], 0), min(w[1], nz)

        self.send, self.send_at = [], []         # my planes for rank s
        self.recv = []                           # rank s's planes for me
        for s in range(ranks.size):
            a, b = overlap(own[r], clip(want[s]))
            self.send.append(max(0, b - a) * plane)
            self.send_at.append((a - own[r][0]) * plane if b > a else 0)
            a, b = overlap(own[s], clip(want[r]))
            self.recv.append(max(0, b - a) * plane)

    def _exchange(self, pieces, sizes, like: torch.Tensor) -> list:
        """Send ``pieces[s]`` to every rank s and receive ``sizes[s]``
        values from it: point-to-point, only between ranks that share
        planes (a rank's own piece stays where it is)."""
        me, group = self.ranks.rank, self.ranks.group
        got = [pieces[s] if s == me else like.new_empty(n)
               for s, n in enumerate(sizes)]
        ops = []
        for s in range(self.ranks.size):
            if s == me:
                continue
            if pieces[s].numel():
                ops.append(dist.P2POp(dist.isend, pieces[s].contiguous(), s,
                                      group))
            if sizes[s]:
                ops.append(dist.P2POp(dist.irecv, got[s], s, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def gather(self, x: torch.Tensor, zeros: bool = True) -> torch.Tensor:
        """Owned planes [n_own * plane] -> the window [n_want * plane];
        with ``zeros`` False, its planes inside the grid only (where this
        rank is their only owner, ``x`` itself)."""
        got = self._exchange([x.narrow(0, at, n) for at, n in
                              zip(self.send_at, self.send)], self.recv, x)
        pad = self.plane
        if not zeros:
            got = [g for g in got if g.numel()]
            return got[0] if len(got) == 1 else torch.cat(got)
        return torch.cat([x.new_zeros(self.below * pad), *got,
                          x.new_zeros(self.above * pad)])

    def scatter_add(self, w: torch.Tensor) -> torch.Tensor:
        """Contributions to the window's planes inside the grid -> the
        owned planes' sums, the ranks' contributions added in rank order
        (where this rank is the only contributor, a view of ``w``)."""
        at, pieces = 0, []
        for n in self.recv:
            pieces.append(w.narrow(0, at, n))
            at += n
        got = self._exchange(pieces, self.send, w)
        n_own = (self.own[1] - self.own[0]) * self.plane
        if self.send == [n_own if s == self.ranks.rank else 0
                         for s in range(self.ranks.size)]:
            return got[self.ranks.rank]             # the only contributor
        y = w.new_zeros(n_own)
        for s, n in enumerate(self.send):
            if n:
                y.narrow(0, self.send_at[s], n).add_(got[s])
        return y


def slabs(nz: int, size: int) -> list:
    """The owned planes of every rank."""
    step = nz // size
    return [(r * step, (r + 1) * step) for r in range(size)]


def need_divisible(nz: int, n_dom: int, size: int) -> None:
    if nz % size or n_dom % size:
        raise ValueError(
            f"nz={nz} (vector slabs) and n_dom={n_dom} (domain chunks) "
            f"must divide the mesh size {size}")


@dataclass(frozen=True)
class SlabOp:
    """A global operator (GlobalStencil or ElasticOp) on the rank's
    planes: ``op`` holds the fields of the owned planes and one plane on
    each side (zero outside the grid); ``matvec`` gathers x there, applies
    ``op`` and keeps the owned planes."""

    op: object
    plan: PlanePlan

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = self.op.matvec(self.plan.gather(x))
        p = self.plan.plane
        return y.narrow(0, p, x.shape[0])


def _planes_of(f: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Planes [lo, hi) of a [nz, ...] field, zero outside [0, nz)."""
    nz = f.shape[0]
    a, b = max(lo, 0), min(hi, nz)
    parts = [f.new_zeros((a - lo,) + f.shape[1:]), f[a:b],
             f.new_zeros((hi - b,) + f.shape[1:])]
    return torch.cat(parts).contiguous()


def shard_refine64(op, ranks: Ranks):
    """A GlobalStencil or ElasticOp on the rank's planes, one plane of
    halo each side (the float64 truth operator of the refinement, or the
    operator of the inner iterations)."""
    nx, ny, nz = op.grid_shape
    own = slabs(nz, ranks.size)
    lo, hi = own[ranks.rank]
    want = [(a - 1, b + 1) for a, b in own]
    if hasattr(op, "coeff"):                     # GlobalStencil
        ext = dataclasses.replace(
            op, diag=_planes_of(op.diag, lo - 1, hi + 1),
            coeff=tuple(_planes_of(c, lo - 1, hi + 1) for c in op.coeff),
            grid_shape=(nx, ny, hi - lo + 2))
        plane = nx * ny
    else:                                        # ElasticOp
        # cells between node planes lo-1 .. hi (zero weight off the grid)
        ext = dataclasses.replace(
            op, e_cell=_planes_of(op.e_cell, lo - 1, hi),
            bc=_planes_of(op.bc, lo - 1, hi + 1),
            grid_shape=(nx, ny, hi - lo + 2))
        plane = 3 * nx * ny
    return SlabOp(op=ext, plan=PlanePlan(nz, plane, own, want, ranks))


def _chunk(tree, lo: int, hi: int):
    """Domains [lo, hi) of a setup product: every tensor has a leading
    domain axis but 0-d scalars, the element stiffness ``k0`` and the
    block-tridiagonal factors (domains on axis 1)."""
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi] if tree.ndim else tree
    if isinstance(tree, tuple):
        return tuple(_chunk(v, lo, hi) for v in tree)
    if isinstance(tree, BlockTridiagFactor):
        return BlockTridiagFactor(w=tree.w[:, lo:hi], c=tree.c[:, lo:hi])
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _chunk(getattr(tree, f.name), lo, hi)
            for f in dataclasses.fields(tree) if f.name != "k0"})
    return tree


@dataclass(frozen=True)
class ShardedGenEO(LocalSchwarz):
    """A set-up StructuredGenEO or ElasticGenEO on the rank's planes and
    domains.  ``pc`` is the rank's chunk of it (its domains, E
    replicated); vectors are the owned planes, flat [n_own] (``ncomp`` 1)
    or node-major [3 n_own] (``ncomp`` 3)."""

    pc: object
    op: SlabOp                # the inner iterations' global operator
    plan: PlanePlan           # the window of the rank's boxes
    ip: DistInner
    ncomp: int
    n_layers: int
    row0: int                 # the rank's first domain in its layers
    x0: torch.Tensor          # owned planes of pc.x0

    lvl1 = property(lambda self: self.pc.lvl1)
    lvl2 = property(lambda self: self.pc.lvl2)
    hybrid = property(lambda self: self.pc.hybrid)
    eff_hybrid = property(lambda self: self.pc.eff_hybrid)
    l1 = property(lambda self: self.pc.l1)
    maskf = property(lambda self: self.pc.maskf)
    l1_exact = property(lambda self: getattr(self.pc, "l1_exact", False))

    def _sides(self):
        """Whether the window has planes beside its layers inside the
        grid, below and above."""
        return self.plan.below == 0, self.plan.above == 0

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        xw = self.plan.gather(x, zeros=False)
        if self.ncomp == 3:
            xw = xw.reshape(-1, 3).T
        b = halo.to_batch(halo.window_gather(
            xw, self.pc.grid_shape, self.pc.dom_grid, self.pc.pad,
            self.n_layers, self._sides()))
        return b.narrow(0, self.row0, self.pc.maskf.shape[0])

    def _scatter(self, ub: torch.Tensor) -> torch.Tensor:
        gx, gy, _gz = self.pc.dom_grid
        n = self.n_layers * gx * gy
        if ub.shape[0] != n:
            full = ub.new_zeros((n,) + ub.shape[1:])
            full.narrow(0, self.row0, ub.shape[0]).copy_(ub)
            ub = full
        yw = halo.window_fold(ub.reshape((self.n_layers, gy, gx)
                                         + ub.shape[1:]),
                              self.pc.grid_shape, self.pc.dom_grid,
                              self.pc.pad, self._sides())
        if self.ncomp == 3:
            yw = yw.T.reshape(-1)
        return self.plan.scatter_add(yw)

    def _coarse_w(self, ztx: torch.Tensor) -> torch.Tensor:
        """The global coarse vector: each rank places its domains' real
        entries, one all_reduce adds the ranks' (each entry is written by
        exactly one rank)."""
        w = ztx.new_zeros(self.pc.dim_e + 1)
        w[self.pc.colids.reshape(-1)] = ztx
        w = w[:-1].contiguous()
        dist.all_reduce(w, group=self.ip.group)
        return w

    def coarse_local(self, xb, coarse_w=None):
        return self.pc.coarse_local(xb, self._coarse_w)

    def l1_local(self, xb):
        return self.pc.l1_local(xb)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.matvec(x)

    def shard(self, v) -> torch.Tensor:
        """A global vector (host array or tensor) -> its owned planes."""
        lo, hi = self.plan.own
        p = self.plan.plane
        return torch.as_tensor(v)[lo * p:hi * p].to(self.x0.device)

    def unshard(self, x: torch.Tensor) -> np.ndarray:
        """Owned planes of every rank -> the global vector on the host."""
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(self.ip.group))]
        dist.all_gather(parts, x.contiguous(), group=self.ip.group)
        return torch.cat(parts).cpu().numpy()


def _shard(pc, ranks: Ranks, ncomp: int, op=None) -> ShardedGenEO:
    nx, ny, nz = pc.grid_shape
    gx, gy, gz = pc.dom_grid
    n_dom = gx * gy * gz
    need_divisible(nz, n_dom, ranks.size)
    iz, pz = nz // gz, pc.pad[2]
    cnt = n_dom // ranks.size
    own = slabs(nz, ranks.size)
    want = []
    for r in range(ranks.size):
        p0, p1 = r * cnt // (gx * gy), ((r + 1) * cnt - 1) // (gx * gy)
        want.append((p0 * iz - pz, (p1 + 1) * iz + pz))
    d0 = ranks.rank * cnt
    p0, p1 = d0 // (gx * gy), (d0 + cnt - 1) // (gx * gy)
    ip = DistInner(ranks.group)
    l1 = _chunk(pc.l1, d0, d0 + cnt)
    if isinstance(l1, PCGSolver):
        l1 = dataclasses.replace(l1, ip=ip)
    chunk = dataclasses.replace(
        pc, l1=l1, pou=_chunk(pc.pou, d0, d0 + cnt),
        maskf=_chunk(pc.maskf, d0, d0 + cnt), z=_chunk(pc.z, d0, d0 + cnt),
        colids=_chunk(pc.colids, d0, d0 + cnt), col_sel=None, x0=None,
        gop=None)
    plane = ncomp * nx * ny
    lo, hi = own[ranks.rank]
    return ShardedGenEO(pc=chunk, op=shard_refine64(op or pc.gop, ranks),
                        plan=PlanePlan(nz, plane, own, want, ranks), ip=ip,
                        ncomp=ncomp, n_layers=p1 - p0 + 1,
                        row0=d0 - p0 * gx * gy,
                        x0=pc.x0[lo * plane:hi * plane])


def shard_structured(pc, ranks: Ranks):
    """Place a set-up StructuredGenEO on this rank's planes and domains;
    returns (matvec, apply, pc_sh, shard_vec) with owned-plane vector
    signatures, as the JAX package's shard_structured."""
    sh = _shard(pc, ranks, 1)
    return sh.matvec, sh.apply, sh, sh.shard


def shard_elastic(pc, ranks: Ranks, op=None):
    """The same for a set-up ElasticGenEO: flat [3n] vectors in the same
    z-slabs, the cell sum with one node plane each side, the per-cell
    modulus of those planes replicated.  ``op``: the inner iterations'
    global operator (default pc.gop)."""
    sh = _shard(pc, ranks, 3, op)
    return sh.matvec, sh.apply, sh, sh.shard
