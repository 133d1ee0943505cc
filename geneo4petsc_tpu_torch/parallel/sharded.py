"""Multi-rank generic path with replicated vectors (the JAX package's
parallel/sharded.py).

Every rank holds the whole global vector and its own chunk of the
subdomain batch; the reference's one-subdomain-per-rank layout
(SURVEY.md §2.9) with the halo exchange replaced by sums:

  * level-1 gather (global -> local copies): local indexing;
  * level-1 scatter-add and the MatIS SpMV: the chunk's sum by the
    deterministic scatter table, then an ``all_reduce`` of the full
    vector;
  * coarse Z^T x: an ``all_reduce`` of the [dim_e] vector;
  * E's factor: replicated;
  * Krylov dot products: on the replicated vectors, local.

Correct on any group, but every reduction moves the whole vector:
parallel/dist.py is the owner-block twin whose wire volume is the halo.
Ranks take contiguous chunks of ceil(n_dom / D) domains (the last ones
may hold fewer, or none), the JAX package's padded split without the
pad blocks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..assembly.assemble import SubdomainBatch, scatter_table
from .multiproc import Ranks


def chunk_range(n_dom: int, ranks: Ranks) -> tuple:
    """The domains [lo, hi) of this rank: chunks of ceil(n_dom / D)."""
    per = -(-n_dom // ranks.size)
    lo = min(ranks.rank * per, n_dom)
    return lo, min(lo + per, n_dom)


def chunk_pc(pc, lo: int, hi: int, batch, x0):
    """A GenEOPreconditioner with its domain-batched fields cut to
    [lo, hi) and ``batch`` swapped in; E's factor is shared."""
    l1 = pc.l1_factor
    l1 = tuple(t[lo:hi] for t in l1) if isinstance(l1, tuple) else l1[lo:hi]

    def cut(t):
        return None if t is None else t[lo:hi]

    return dataclasses.replace(pc, batch=batch, l1_factor=l1,
                               pou=cut(pc.pou), z_loc=cut(pc.z_loc),
                               colids=cut(pc.colids), x0=x0)


@dataclass(frozen=True)
class ReplicatedBatch(SubdomainBatch):
    """A rank's chunk of a SubdomainBatch over replicated global vectors:
    gathers are local, every sum ends in an ``all_reduce``."""

    group: object = None

    def scatter_add(self, xl: torch.Tensor) -> torch.Tensor:
        y = super().scatter_add(xl)
        dist.all_reduce(y, group=self.group)
        return y

    def coarse_sum(self, w: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(w, group=self.group)
        return w


def shard_batch(batch: SubdomainBatch, ranks: Ranks) -> ReplicatedBatch:
    """This rank's chunk of ``batch`` (the reference's sendDomain)."""
    lo, hi = chunk_range(batch.n_dom, ranks)
    gids = batch.gids[lo:hi]
    table = scatter_table(gids.cpu().numpy(), batch.n_dof)
    return ReplicatedBatch(
        n_dof=batch.n_dof, n_dom=hi - lo, n_max=batch.n_max, gids=gids,
        mask=batch.mask[lo:hi], mult=batch.mult[lo:hi],
        a_neu=batch.a_neu[lo:hi],
        a_dir=None if batch.a_dir is None else batch.a_dir[lo:hi],
        scatter_idx=torch.as_tensor(table, device=batch.device),
        group=ranks.group)


def sharded_matvec(batch: SubdomainBatch, ranks: Ranks):
    """The global SpMV on replicated vectors, each rank's block products
    on its own chunk."""
    return shard_batch(batch, ranks).matvec


def shard_geneo(pc, ranks: Ranks):
    """A set-up GenEOPreconditioner on this rank's chunk; returns
    (matvec, pc_apply, pc_sh) with replicated-vector signatures."""
    lo, hi = chunk_range(pc.batch.n_dom, ranks)
    pc_sh = chunk_pc(pc, lo, hi, shard_batch(pc.batch, ranks), pc.x0)
    return pc_sh.batch.matvec, pc_sh.apply, pc_sh
