"""geneo4petsc_tpu_torch — the PyTorch + CUDA port of geneo4petsc_tpu.

The generic GenEO solve path (element input, k-way partitioning,
MatIS assembly, the GenEO preconditioner, CG/GMRES and the CLI) on
PyTorch tensors, with hand-written CUDA kernels for the batched
per-subdomain products (``ops/local_kernels.py``, ``csrc/``).  Every
function takes an explicit ``device``; nothing sets a global default."""

__version__ = "0.1.0"
