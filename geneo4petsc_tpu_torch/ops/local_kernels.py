"""The per-iteration batched subdomain products: CUDA kernels, their
plain PyTorch versions, launch plans and launch counters.

* ``fused_local_solve`` (K1): the level-1 local solve with precomputed
  block inverses, ``o = mask * D^post * (Minv @ (D^pre * x))`` per
  subdomain — the counterpart of the Pallas kernel
  ``geneo4petsc_tpu.ops.pallas_kernels.fused_local_solve``.
* ``block_matvec`` (K2): ``o = A_d @ x_d`` per subdomain, the local
  product of the MatIS SpMV — the counterpart of
  ``geneo4petsc_tpu.ops.pallas_kernels.block_matvec``.

A wrapper runs the plain version for tensors on the CPU and launches its
CUDA kernel (``csrc/``, built at first use by ``ops/_build.py``) for
tensors on a CUDA device; it never falls back from one to the other.
Each wrapper counts its kernel launches in its ``launches`` attribute.

Both kernels stream the matrix batch through one of two hand-written
paths (``csrc/batched_gemv.cuh``): ``"ring"``, persistent blocks fed by
bulk copies into a ring of row tiles in shared memory, for batches whose
base pointer and row size are multiples of 16 bytes; and ``"direct"``,
one warp per four rows loading straight from device memory, for every
other batch.  ``_stream_plan`` chooses the path and its geometry from the
shapes, the alignment and the card's limits; the kernels only check it.
``plan_for`` caches the plan per (shape, dtype, alignment, card), and a
launch switches the current device only when the batch lives on another
card: at small batches a call costs mostly its host side.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple

import torch

from . import _build

_DTYPES = (torch.float64, torch.float32)

# Constants shared with csrc/batched_gemv.cuh.
ROWS_PER_WARP = 4        # rows a warp reduces at once
MAX_STAGES = 8           # deepest ring
BARRIER_BYTES = 128      # the ring's barriers in shared memory
_PATH_CODE = {"direct": 0, "ring": 1}
# Geometry chosen here.
STAGE_BYTES = 64 * 1024  # aim of one ring stage
RING_THREADS = 160       # one producer warp + four consumer warps
DIRECT_THREADS = 256     # eight warps of four rows
BLOCKS_PER_SM = 1        # persistent ring blocks per SM


class StreamPlan(NamedTuple):
    """Launch geometry of one batched-GEMV kernel."""
    path: str      # "ring" or "direct"
    rows: int      # rows per tile (ring) or per block (direct)
    stages: int    # tiles in the ring (0 on the direct path)
    grid: int      # blocks
    threads: int   # threads per block
    smem: int      # dynamic shared memory per block, bytes


def _align_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _ring_smem(n: int, itemsize: int, extra: int, rows: int,
               stages: int) -> int:
    """Shared memory of a ring block: barriers, x[d], ``extra`` bytes of
    the store's operands, the stages."""
    return (BARRIER_BYTES + _align_up(n * itemsize, 128)
            + _align_up(extra, 128) + stages * rows * n * itemsize)


def _stream_plan(n_dom: int, n: int, itemsize: int, aligned: bool,
                 sm_count: int, smem_limit: int, extra: int = 0
                 ) -> StreamPlan:
    """Path and geometry for a [n_dom, n, n] batch of ``itemsize``-byte
    elements whose base pointer is (``aligned``) or is not a multiple of
    16 bytes, on a card with ``sm_count`` SMs and ``smem_limit`` bytes
    of dynamic shared memory a block.  ``extra``: bytes per domain that
    the ring stages beside x[d] for the store (K1: mask and post-weight).

    The ring needs every tile to start and end on a 16-byte boundary
    (aligned base, row size a multiple of 16) and room for x[d] and at
    least two stages of one row; all else goes the direct path."""
    row_bytes = n * itemsize
    if (aligned and row_bytes % 16 == 0
            and _ring_smem(n, itemsize, extra, 1, 2) <= smem_limit):
        room = smem_limit - _ring_smem(n, itemsize, extra, 0, 0)
        # about STAGE_BYTES a stage, but never so much that two do not fit
        rows = max(1, min(n, STAGE_BYTES // row_bytes,
                          room // (2 * row_bytes)))
        if rows > ROWS_PER_WARP:
            rows -= rows % ROWS_PER_WARP
        items = n_dom * -(-n // rows)
        grid = min(items, BLOCKS_PER_SM * sm_count)
        # no deeper than the longest walk of a block, no shallower than 2
        stages = min(MAX_STAGES, room // (rows * row_bytes),
                     max(2, -(-items // grid)))
        return StreamPlan("ring", rows, stages, grid, RING_THREADS,
                          _ring_smem(n, itemsize, extra, rows, stages))
    rows = DIRECT_THREADS // 32 * ROWS_PER_WARP
    return StreamPlan("direct", rows, 0, n_dom * -(-n // rows),
                      DIRECT_THREADS, row_bytes)


def stream_tiles(plan: StreamPlan, n_dom: int, n: int
                 ) -> Iterator[tuple[int, int, int, int]]:
    """(block, domain, first row, rows) of every tile in the order the
    kernels walk them (gemv_ring_kernel and gemv_direct_kernel of
    csrc/batched_gemv.cuh): item = domain * tiles + tile, and block b
    takes the items [items * b // grid, items * (b + 1) // grid)."""
    tiles = -(-n // plan.rows)
    items = n_dom * tiles
    for b in range(plan.grid):
        for item in range(items * b // plan.grid,
                          items * (b + 1) // plan.grid):
            d, t = divmod(item, tiles)
            r0 = t * plan.rows
            yield b, d, r0, min(plan.rows, n - r0)


_cached_plan = functools.lru_cache(maxsize=None)(_stream_plan)


@functools.cache
def _device_limits(index: int) -> tuple[int, int]:
    """(number of SMs, most dynamic shared memory of a block) of a card."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def plan_for(mat: torch.Tensor, extra: int = 0) -> StreamPlan:
    """The plan of a CUDA matrix batch on its own card (cached)."""
    index = mat.device.index
    if index is None:
        index = torch.cuda.current_device()
    return _cached_plan(mat.shape[0], mat.shape[1], mat.element_size(),
                        mat.data_ptr() % 16 == 0, *_device_limits(index),
                        extra)


def _launch(wrapper, entry: str, mat: torch.Tensor, args: tuple,
            plan: StreamPlan) -> None:
    """Launch ``entry`` of the kernel library on ``mat``'s card and
    stream, count it on ``wrapper`` and raise on a CUDA error."""
    fn = getattr(_build.load(), entry)
    call = (mat.data_ptr(), *args, _PATH_CODE[plan.path], plan.rows,
            plan.stages, plan.grid, plan.threads, plan.smem)
    index = mat.device.index
    if index == torch.cuda.current_device():
        # the current stream's raw handle (torch.cuda.current_stream()
        # builds a Stream object: several microseconds a call)
        err = fn(*call, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(mat.device):
            err = fn(*call, torch.cuda.current_stream().cuda_stream)
    wrapper.launches += 1
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: CUDA error {err} "
                           f"(plan {plan})")


def fused_local_solve_plain(inv: torch.Tensor, d: torch.Tensor | None,
                            mask: torch.Tensor, xl: torch.Tensor,
                            pre: bool = False, post: bool = False
                            ) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    x = xl * d if pre else xl
    y = torch.bmm(inv, x.unsqueeze(-1)).squeeze(-1)
    if post:
        y = y * d
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def block_matvec_plain(a: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    return torch.bmm(a, xl.unsqueeze(-1)).squeeze(-1)


def _check(name: str, mat: torch.Tensor, vecs: dict) -> None:
    """Shape, dtype, device and contiguity checks shared by both
    wrappers: ``mat`` is [n_dom, n, n], every vector [n_dom, n]."""
    if mat.dim() != 3 or mat.shape[1] != mat.shape[2]:
        raise ValueError(f"{name}: matrix batch must be [n_dom, n, n], "
                         f"got {tuple(mat.shape)}")
    if mat.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {mat.dtype} not supported "
                        "(float64 or float32)")
    if not mat.is_contiguous():
        raise ValueError(f"{name}: matrix batch must be contiguous")
    for vname, v in vecs.items():
        if v.shape != mat.shape[:2]:
            raise ValueError(f"{name}: {vname} must be "
                             f"{tuple(mat.shape[:2])}, got {tuple(v.shape)}")
        want = torch.bool if vname == "mask" else mat.dtype
        if v.dtype != want:
            raise TypeError(f"{name}: {vname} dtype {v.dtype}, want {want}")
        if v.device != mat.device:
            raise ValueError(f"{name}: {vname} on {v.device}, matrix on "
                             f"{mat.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {vname} must be contiguous")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {mat.device}")


def fused_local_solve(inv: torch.Tensor, d: torch.Tensor | None,
                      mask: torch.Tensor, xl: torch.Tensor,
                      pre: bool = False, post: bool = False) -> torch.Tensor:
    """Batched fused (D.)Minv(D.) apply (K1).

    inv  [n_dom, n, n]  precomputed block inverses
    d    [n_dom, n]     partition of unity (may be None if not pre/post)
    mask [n_dom, n]     bool, real-slot mask
    xl   [n_dom, n]     gathered local copies
    pre/post: RAS / SRAS weighting flags (applyLevel1, geneo.cpp:1991-2002)
    """
    vecs = {"mask": mask, "x": xl}
    if pre or post:
        if d is None:
            raise ValueError("fused_local_solve: pre/post need the weights d")
        vecs["d"] = d
    _check("fused_local_solve", inv, vecs)
    if inv.device.type == "cpu":
        return fused_local_solve_plain(inv, d, mask, xl, pre, post)
    if xl.numel() == 0:
        return torch.empty_like(xl)
    return _fused_local_solve_cuda(
        inv, d, mask, xl, pre, post,
        plan_for(inv, _local_solve_extra(inv.shape[1], inv.element_size(),
                                         post)))


def _local_solve_extra(n: int, itemsize: int, post: bool) -> int:
    """Bytes per domain that K1's ring stages for its store: the mask
    and, when post-weighted, the weights from the next 16-byte boundary
    (LocalSolveOp::extra_bytes of csrc/fused_local_solve.cu)."""
    return _align_up(n, 16) + n * itemsize if post else n


def _fused_local_solve_cuda(inv, d, mask, xl, pre, post,
                            plan: StreamPlan) -> torch.Tensor:
    """K1 on the card with a given plan."""
    out = torch.empty_like(xl)
    _launch(fused_local_solve, "g4p_fused_local_solve", inv,
            (d.data_ptr() if d is not None else None, mask.data_ptr(),
             xl.data_ptr(), out.data_ptr(), inv.shape[0], inv.shape[1],
             int(pre), int(post), int(inv.dtype == torch.float64)), plan)
    return out


def block_matvec(a: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    """Batched per-domain A_d @ x_d (K2, the compute core of the MatIS
    SpMV).  a [n_dom, n, n], xl [n_dom, n]."""
    _check("block_matvec", a, {"x": xl})
    if a.device.type == "cpu":
        return block_matvec_plain(a, xl)
    if xl.numel() == 0:
        return torch.empty_like(xl)
    return _block_matvec_cuda(a, xl, plan_for(a))


def _block_matvec_cuda(a, xl, plan: StreamPlan) -> torch.Tensor:
    """K2 on the card with a given plan."""
    out = torch.empty_like(xl)
    _launch(block_matvec, "g4p_block_matvec", a,
            (xl.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
             int(a.dtype == torch.float64)), plan)
    return out


fused_local_solve.launches = 0
block_matvec.launches = 0
