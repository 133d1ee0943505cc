"""Workload generators ("model families") mirroring the reference plugins
(tst/laplacian, tst/heat, tst/graph) plus the elasticity family."""

from ..io.plugin import register_generator
from . import elasticity, graph, heat, laplacian

register_generator("laplacian", laplacian.get_input)
register_generator("heat", heat.get_input)
register_generator("graph", graph.get_input)
register_generator("elasticity", elasticity.get_input)

__all__ = ["laplacian", "heat", "graph", "elasticity"]
