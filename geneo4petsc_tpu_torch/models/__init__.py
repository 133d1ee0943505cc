"""Workload generators ("model families") mirroring the reference plugins.

Only the generators that have been ported are registered; the others
(heat, graph, elasticity) still live only in the JAX package."""

from ..io.plugin import register_generator
from . import laplacian

register_generator("laplacian", laplacian.get_input)

__all__ = ["laplacian"]
