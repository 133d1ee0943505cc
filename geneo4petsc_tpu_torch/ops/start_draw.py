"""The structured path's LOBPCG start block: the JAX package's draw,
``jax.random.normal(jax.random.PRNGKey(0), (d, n, k))``, written masked
in the [d, k, n] layout the eigensolve runs in.

JAX draws element ``i`` of the flat [d, n, k] array from the partitionable
Threefry-2x32 hash (20 rounds, key (0, 0)) of the counter pair
(i >> 32, i & 0xffffffff), maps the bits to a uniform u on
[nextafter(-1, 0), 1) and returns sqrt(2) erf^-1(u).  Every element is
independent, so the same numbers come out on every device:

* ``jax_normal32`` / ``jax_normal64`` / ``jax_start``: the draw rebuilt
  with torch ops, on any device (the plain version);
* ``start_draw(mask, k)``: ``x0[dom, col, p] = mask[dom, p] * N(((dom * n)
  + p) * k + col)`` into a new contiguous [d, k, n] tensor.  For a CPU
  mask it computes the plain version; for a CUDA mask it launches the
  kernel of ``csrc/start_draw.cu`` (built at first use by
  ``ops/_build.py``) and never falls back.  ``start_draw.launches`` counts
  its kernel launches.

Against ``jax.random.normal`` on the CPU: the Threefry bits and the
uniforms are exact.  float32 follows XLA's formula for erf^-1 (Giles'
single-precision polynomials, evaluated with fused multiply-adds as
fully compiled XLA CPU code is); only log1p differs from XLA's own, which
leaves the draw within 3 units in the last place, 99% of it equal.
float64 uses the device's own erf^-1, within 1e-15 of the exact value,
so the draw agrees with JAX's to 1e-14 relative up to |N| ~ 3.75 and by
up to 3e-12 beyond, where JAX's float64 erf^-1 is the less accurate one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

_M32 = 0xFFFFFFFF
THREADS = 256           # threads a block of the kernel
_MAX_GRID_Y = 65535     # CUDA's limit on gridDim.y


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k0, k1); uint32 values held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _bits(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry pairs (b1, b2) of the flat indices 0..n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(0, 0, idx >> 32, idx & _M32)


# Giles' single-precision erfinv polynomials, as XLA evaluates erf_inv
# in float32 (for w = -log1p(-x^2) below 5, and from 5 up); the same
# constants are in csrc/start_draw.cu
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of float32 x by XLA's float32 formula, in float32.  Each
    step c + p w of the polynomial is one fused multiply-add, as XLA's
    CPU code and the kernel compute it: the float32 product is exact in
    float64, so the step is rounded once, to float32."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = torch.where(lt, c_lt, c_ge)     # float32 constants
        p = (c.double() + p.double() * w).float()
    return p * x


def jax_normal32(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32),
    rebuilt with torch."""
    b1, b2 = _bits(int(np.prod(shape)), device)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    # u * (1 - lo) + lo on [lo, 1), lo = nextafter(-1, 0); 1 - lo rounds
    # to 2 in float32, as in JAX
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)),
                      device=device)
    u = torch.maximum(lo, u * 2.0 + lo)
    return (torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
            * _erfinv32(u)).reshape(shape)


def jax_normal64(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64),
    rebuilt with torch: the partitionable Threefry pair gives the 64 bits
    (b1 << 32 | b2) and the uniform they map to exactly; the inverse
    error function is torch's float64 one."""
    b1, b2 = _bits(int(np.prod(shape)), device)
    # the top 52 of the 64 bits as the mantissa of a float in [1, 2)
    mant = ((b1 << 20) | (b2 >> 12)) & ((1 << 52) - 1)
    u = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = torch.tensor(np.nextafter(-1.0, 0.0), dtype=torch.float64,
                      device=device)
    u = torch.maximum(lo, u * (1.0 - lo) + lo)
    return (np.sqrt(2.0) * torch.special.erfinv(u)).reshape(shape)


def jax_start(d: int, n: int, k: int, dtype, device="cpu") -> torch.Tensor:
    """The JAX package's LOBPCG start block (structured/geneo.py and
    structured/elastic.py draw jax.random.normal(PRNGKey(0), (d, n,
    k))), [d, n, k] in float32 or float64: a ``lobpcg_start`` callback."""
    if dtype == torch.float32:
        return jax_normal32((d, n, k), device)
    if dtype == torch.float64:
        return jax_normal64((d, n, k), device)
    raise ValueError(f"jax_start: no draw for {dtype}")


def start_draw_plain(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: JAX's [d, n, k] draw on the
    mask's device, transposed to [d, k, n] and masked."""
    d, n = mask.shape
    x0 = jax_start(d, n, k, mask.dtype, mask.device).transpose(1, 2)
    return (x0 * mask[:, None, :]).contiguous()


def _check(mask: torch.Tensor, k: int) -> None:
    if mask.dim() != 2:
        raise ValueError(f"start_draw: mask must be [d, n], got "
                         f"{tuple(mask.shape)}")
    if mask.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"start_draw: dtype {mask.dtype} not supported "
                        "(float64 or float32)")
    if not mask.is_contiguous():
        raise ValueError("start_draw: mask must be contiguous")
    if k < 1:
        raise ValueError(f"start_draw: k must be positive, got {k}")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"start_draw: unsupported device {mask.device}")


def start_draw(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The masked [d, k, n] LOBPCG start block of a [d, n] mask, in its
    dtype and on its device: x0[dom, col, p] = mask[dom, p] * JAX's
    PRNGKey(0) normal of flat index ((dom * n) + p) * k + col."""
    _check(mask, k)
    if mask.device.type == "cpu":
        return start_draw_plain(mask, k)
    return _start_draw_cuda(mask, k)


def _start_draw_cuda(mask: torch.Tensor, k: int,
                     threads: int = THREADS) -> torch.Tensor:
    """The kernel on the mask's card and current stream; raises on a
    CUDA error (a refused launch among them)."""
    d, n = mask.shape
    out = torch.empty((d, k, n), dtype=mask.dtype, device=mask.device)
    if out.numel() == 0:
        return out
    grid_x = min(-(-n // threads), 2 ** 31 - 1)
    grid_y = min(d, _MAX_GRID_Y)
    with torch.cuda.device(mask.device):
        err = _build.load().g4p_start_draw(
            mask.data_ptr(), out.data_ptr(), d, k, n,
            int(mask.dtype == torch.float64), grid_x, grid_y, threads,
            torch.cuda.current_stream().cuda_stream)
    start_draw.launches += 1
    if err != 0:
        raise RuntimeError(f"start_draw: CUDA error {err} (grid "
                           f"{grid_x}x{grid_y}, {threads} threads)")
    return out


start_draw.launches = 0
