"""Roofline arithmetic, frozen: the card's published peaks, the least
time a piece of work could take, and the byte and operation model of
the 7-point stencil product.

A copy of the measured package's ``utils/roofline.py`` (``PEAKS``,
``bound_ms``, ``stencil_model``), kept here so that the yardstick does
not move with the program.  Models count each input byte read once and
each output byte written once.
"""

from __future__ import annotations

# NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at
# its 700 W limit; float32 / float64 are the rates outside the tensor
# cores.  Keyed on torch.cuda.get_device_name.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "flops": {"float32": 67e12, "float64": 34e12, "tf32": 495e12,
                  "bfloat16": 989e12},
        "source": "NVIDIA H100 data sheet, SXM part, dense, 700 W",
    },
}


def bound_ms(n_bytes: float, flops: float, dtype: str, peaks: dict
             ) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    dtype's peak rate, in ms, and which of the two it is."""
    by_bytes = n_bytes / peaks["hbm_bytes_per_s"] * 1e3
    by_ops = flops / peaks["flops"][dtype] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def stencil_model(n: int, isz: int) -> tuple[int, int]:
    """(bytes, operations) of the global 7-point product on n nodes of
    ``isz``-byte items: x, y, the diagonal and the three edge fields;
    2 operations per neighbour pair and axis side, and the diagonal."""
    return 6 * n * isz, 14 * n
