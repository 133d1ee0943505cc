"""Multi-rank generic path: owner-block vectors and a halo exchange (the
JAX package's parallel/dist.py; the generic CLI's ``--nbDevices``).

The VecScatter equivalent for the unstructured path.  The global vector
is split over the ranks in contiguous owner blocks (one block of DOFs a
rank, PETSc's rank-contiguous ordering), and each gather or scatter-add
moves only the halo entries a rank's subdomains touch, through one
packed ``all_to_all_single`` a direction:

  * gather (VecScatter forward/INSERT, src/geneo.cpp:1845-1869): the
    owned block is a local read; halo entries are packed per owner,
    exchanged, and placed by a static index;
  * scatter-add (VecScatter reverse/ADD, src/geneo.cpp:1871-1900): the
    transposed plan; the local sum and the owners' sum of the received
    contributions both run through deterministic scatter tables
    (assembly.scatter_table), so every sum has a fixed order.

The communication plan (who owns what, which entries cross between which
ranks) is built once on the host from the decomposition, the
VecScatterCreate analogue (``_build_plan``, the JAX package's host
NumPy).  DOF ownership follows the non-overlapped partition when given
(``node_part``), else the first containing domain; DOFs are renumbered
so that ownership is block-contiguous, and ``shard_vec`` /
``unshard_vec`` translate at the boundary.  Each rank's local product
and level-1 solve run through the K2 / K1 wrappers on its chunk
(``[ceil(n_dom / D), n_max, n_max]``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..assembly.assemble import scatter_table
from ..ops.local_kernels import block_matvec
from .multiproc import Ranks
from .sharded import chunk_pc, chunk_range


@dataclass(frozen=True)
class DistBatch:
    """A rank's chunk of a subdomain batch over owner-block vectors.

    Has the SubdomainBatch surface that GenEOPreconditioner uses (gather,
    scatter_add, matvec, coarse_sum, pou, mask), so a set-up
    preconditioner runs unchanged with this batch swapped in.

    Local index space: [owned block (blk) | halo (n_halo) | dump].
      gids[p, i]    : local position of the slot; pads -> blk + n_halo;
      send_idx[d, c]: offsets in this rank's block of the entries rank d
                      needs (pad -> blk, reads zero);
      recv_pos[o*C + c]: halo position (blk + h) of the c-th entry
                      received from owner o (pad -> blk + n_halo)."""

    n_dof: int
    n_dom: int              # this rank's domains
    n_max: int
    blk: int
    n_halo: int
    gids: torch.Tensor      # [n_dom, n_max] int64 local positions
    mask: torch.Tensor
    mult: torch.Tensor
    a_neu: torch.Tensor
    a_dir: torch.Tensor | None
    send_idx: torch.Tensor  # [D, max_cnt] int64
    recv_pos: torch.Tensor  # [D * max_cnt] int64
    local_table: torch.Tensor   # scatter table of gids over blk + n_halo
    remote_table: torch.Tensor  # scatter table of send_idx over blk
    group: object = None

    @property
    def device(self) -> torch.device:
        return self.a_neu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.a_neu.dtype

    @property
    def pou(self) -> torch.Tensor:
        return 1.0 / self.mult

    def _swap(self, packed: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(packed)
        dist.all_to_all_single(out, packed, group=self.group)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Owned block [blk] -> local overlapped copies [n_dom, n_max]."""
        xp = torch.cat([x, x.new_zeros(1)])
        recv = self._swap(xp[self.send_idx])           # rows = owners
        halo = x.new_zeros(self.n_halo + 1)
        halo[self.recv_pos - self.blk] = recv.reshape(-1)
        halo[-1] = 0.0                                  # the dump slot
        return torch.cat([x, halo])[self.gids]

    def scatter_add(self, xl: torch.Tensor) -> torch.Tensor:
        """Local copies [n_dom, n_max] -> the owned block [blk] of the
        global sum."""
        flat = torch.cat([xl.reshape(-1), xl.new_zeros(1)])
        yn = torch.cat([flat[self.local_table].sum(dim=1), xl.new_zeros(1)])
        contrib = self._swap(yn[self.recv_pos].reshape(self.send_idx.shape))
        cflat = torch.cat([contrib.reshape(-1), xl.new_zeros(1)])
        return yn[:self.blk] + cflat[self.remote_table].sum(dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """MatIS MatMult over owner-block vectors: K2 on the chunk."""
        return self.scatter_add(block_matvec(self.a_neu, self.gather(x)))

    def coarse_sum(self, w: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(w, group=self.group)
        return w


@dataclass(frozen=True)
class DistPlan:
    """Host-side communication plan and global renumbering (the
    VecScatterCreate product)."""

    n_dof: int
    n_tot: int           # n_dev * blk (padded sharded vector length)
    blk: int
    n_halo: int
    max_cnt: int
    new_pos: np.ndarray  # [n_dof] old gid -> padded sharded position
    gids: np.ndarray     # [n_dom, n_max] int32 local indices
    send_idx: np.ndarray
    recv_pos: np.ndarray

    @property
    def wire_floats_per_exchange(self) -> int:
        """Off-rank floats one gather moves (self rows and pad slots
        excluded).  The replicated path (parallel/sharded.py) moves n_tot
        a rank per reduction."""
        n_dev = self.send_idx.shape[0]
        off = 0
        for o in range(n_dev):
            for d in range(n_dev):
                if o != d:
                    off += int((self.send_idx[o, d] != self.blk).sum())
        return off


def _build_plan(gids: np.ndarray, mask: np.ndarray, n_dof: int,
                n_dev: int, node_part: np.ndarray | None) -> DistPlan:
    """Ownership, renumbering, and packed exchange plan (host, setup).

    Matches the reference's layout choices: one contiguous block of the
    global ordering per rank (geneo4PETSc.cpp:571-641), halo = the
    overlap closure of the owned rows."""
    n_dom, n_max = gids.shape
    dpd = n_dom // n_dev
    dev_of_dom = np.arange(n_dom) // dpd

    if node_part is not None:
        owner_dom = np.asarray(node_part, np.int64)
        if owner_dom.shape[0] != n_dof:
            raise ValueError("node_part length != n_dof")
    else:
        owner_dom = np.full(n_dof, -1, np.int64)
        for p in range(n_dom):
            g = gids[p][mask[p]]
            fresh = owner_dom[g] < 0
            owner_dom[g[fresh]] = p
        if (owner_dom < 0).any():
            raise ValueError("some DOFs belong to no subdomain")
    node_dev = dev_of_dom[np.minimum(owner_dom, n_dom - 1)]

    counts = np.bincount(node_dev, minlength=n_dev)
    blk = max(int(counts.max()), 1)
    new_pos = np.empty(n_dof, np.int64)
    for d in range(n_dev):
        sel = np.flatnonzero(node_dev == d)        # ascending old gid
        new_pos[sel] = d * blk + np.arange(sel.size)
    n_tot = n_dev * blk

    g_new = np.where(mask, new_pos[np.minimum(gids, n_dof - 1)], -1)

    halo_lists, per_pair = [], {}
    for d in range(n_dev):
        rows = slice(d * dpd, (d + 1) * dpd)
        ids = np.unique(g_new[rows][mask[rows]])
        ids = ids[ids >= 0]
        halo = ids[(ids // blk) != d]              # sorted: owner-major
        halo_lists.append(halo)
        owners = halo // blk
        for o in range(n_dev):
            per_pair[o, d] = halo[owners == o]

    n_halo = max(1, max((h.size for h in halo_lists), default=0))
    max_cnt = max(1, max((v.size for v in per_pair.values()), default=0))

    send_idx = np.full((n_dev, n_dev, max_cnt), blk, np.int32)
    recv_pos = np.full((n_dev, n_dev * max_cnt), blk + n_halo, np.int32)
    for (o, d), ids in per_pair.items():
        if ids.size:
            send_idx[o, d, :ids.size] = ids - o * blk
            pos = np.searchsorted(halo_lists[d], ids)
            recv_pos[d, o * max_cnt:o * max_cnt + ids.size] = blk + pos

    lgids = np.full((n_dom, n_max), blk + n_halo, np.int32)
    for d in range(n_dev):
        halo = halo_lists[d]
        for p in range(d * dpd, (d + 1) * dpd):
            m = mask[p]
            g = g_new[p][m]
            own = (g // blk) == d
            hpos = np.searchsorted(halo, g)        # junk for own g: unused
            lgids[p][m] = np.where(own, g - d * blk,
                                   blk + np.minimum(hpos,
                                                    max(halo.size - 1, 0)))
    return DistPlan(n_dof=n_dof, n_tot=n_tot, blk=blk, n_halo=n_halo,
                    max_cnt=max_cnt, new_pos=new_pos, gids=lgids,
                    send_idx=send_idx, recv_pos=recv_pos)


def plan_for(batch, n_dev: int, node_part=None) -> DistPlan:
    """The plan of ``batch`` on ``n_dev`` ranks: the domain axis padded
    to a multiple of n_dev with empty domains, as the JAX package pads
    it (those rows own and touch nothing)."""
    gids = batch.gids.cpu().numpy()
    mask = batch.mask.cpu().numpy()
    extra = -(-batch.n_dom // n_dev) * n_dev - batch.n_dom
    if extra:
        gids = np.concatenate([gids, np.full((extra, batch.n_max),
                                             batch.n_dof, gids.dtype)])
        mask = np.concatenate([mask, np.zeros((extra, batch.n_max), bool)])
    return _build_plan(gids, mask, batch.n_dof, n_dev, node_part)


def dist_geneo(pc, ranks: Ranks, node_part: np.ndarray | None = None):
    """Re-lay a set-up GenEOPreconditioner onto owner-block vectors.
    Returns (matvec, pc_apply, pc_dist, shard_vec, unshard_vec): matvec
    and pc_apply take and return this rank's block [blk]; shard_vec
    takes a global vector (host array or tensor) to the block,
    unshard_vec gathers the blocks back to the global host vector.

    Pass the non-overlapped partition as ``node_part`` for minimal halos;
    without it ownership falls back to the first containing domain.  E's
    factor stays replicated: the per-iteration collectives are the two
    halo exchanges and one [dim_e] all_reduce."""
    batch = pc.batch
    plan = plan_for(batch, ranks.size, node_part)
    lo, hi = chunk_range(batch.n_dom, ranks)
    dev, r = batch.device, ranks.rank
    blk, n_halo = plan.blk, plan.n_halo
    lgids = plan.gids[lo:hi].astype(np.int64)
    local = np.where(batch.mask[lo:hi].cpu().numpy(), lgids, blk + n_halo)
    send = plan.send_idx[r].astype(np.int64)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    db = DistBatch(
        n_dof=batch.n_dof, n_dom=hi - lo, n_max=batch.n_max, blk=blk,
        n_halo=n_halo, gids=put(lgids), mask=batch.mask[lo:hi],
        mult=batch.mult[lo:hi], a_neu=batch.a_neu[lo:hi],
        a_dir=None if batch.a_dir is None else batch.a_dir[lo:hi],
        send_idx=put(send), recv_pos=put(plan.recv_pos[r].astype(np.int64)),
        local_table=put(scatter_table(local, blk + n_halo)),
        remote_table=put(scatter_table(send, blk)), group=ranks.group)

    def shard_vec(x) -> torch.Tensor:
        x = x.detach().cpu() if isinstance(x, torch.Tensor) \
            else torch.as_tensor(np.asarray(x))
        y = x.new_zeros(plan.n_tot)
        y[torch.as_tensor(plan.new_pos)] = x[:plan.n_dof]
        return y[r * blk:(r + 1) * blk].to(dev)

    def unshard_vec(xs: torch.Tensor) -> np.ndarray:
        parts = [torch.empty_like(xs) for _ in range(ranks.size)]
        dist.all_gather(parts, xs.contiguous(), group=ranks.group)
        return torch.cat(parts).cpu().numpy()[plan.new_pos]

    pc_dist = chunk_pc(pc, lo, hi, db, shard_vec(pc.x0))
    return db.matvec, pc_dist.apply, pc_dist, shard_vec, unshard_vec
