"""The per-iteration batched subdomain products: CUDA kernels, their
plain PyTorch versions, and launch counters.

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
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float64, torch.float32)


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
    from ._build import load

    lib = load()
    out = torch.empty_like(xl)
    with torch.cuda.device(inv.device):
        stream = torch.cuda.current_stream(inv.device).cuda_stream
        err = lib.g4p_fused_local_solve(
            inv.data_ptr(), d.data_ptr() if d is not None else None,
            mask.data_ptr(), xl.data_ptr(), out.data_ptr(),
            inv.shape[0], inv.shape[1], int(pre), int(post),
            int(inv.dtype == torch.float64), stream)
    fused_local_solve.launches += 1
    if err != 0:
        raise RuntimeError(f"fused_local_solve: CUDA error {err}")
    return out


def block_matvec(a: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    """Batched per-domain A_d @ x_d (K2, the compute core of the MatIS
    SpMV).  a [n_dom, n, n], xl [n_dom, n]."""
    _check("block_matvec", a, {"x": xl})
    if a.device.type == "cpu":
        return block_matvec_plain(a, xl)
    from ._build import load

    lib = load()
    out = torch.empty_like(xl)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.g4p_block_matvec(
            a.data_ptr(), xl.data_ptr(), out.data_ptr(), a.shape[0],
            a.shape[1], int(a.dtype == torch.float64), stream)
    block_matvec.launches += 1
    if err != 0:
        raise RuntimeError(f"block_matvec: CUDA error {err}")
    return out


fused_local_solve.launches = 0
block_matvec.launches = 0
