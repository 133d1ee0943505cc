"""Irregular "circuit" graph workload generator.

Python port of the behavior of tst/graph/graph.cpp: a central square
resistor block plus ``level`` concentric levels of 4 blocks each,
cross-connected horizontally/vertically, each block optionally grounded to
node 0.  Per-level conductances: block edges l+1, inter-block connections
0.5*(l+1).  Deliberately non-mesh-like: stresses the partitioner and
produces variable subdomain sizes.

Args: --size N --level L --weakScaling W --inpEps E --noGround.
"""

from __future__ import annotations

import math

import numpy as np

from ..io.element_input import ElementMesh, from_lists
from . import _grid

# Border tuple layout: (up, right, down, left), each a sorted node-id list.


def _conductance_mat(l: float, inp_eps: float) -> np.ndarray:
    return l * np.array([[1.0 + inp_eps, -1.0], [-1.0, 1.0 + inp_eps]])


class _Builder:
    def __init__(self, inp_eps: float, no_ground: bool):
        self.inp_eps = inp_eps
        self.no_ground = no_ground
        self.elem_dofs: list[np.ndarray] = []
        self.elem_mats: list[np.ndarray] = []
        self.borders: list[tuple[list[int], list[int], list[int], list[int]]] = []
        self.node_id = 0 if no_ground else 1

    def add_element(self, id1: int, id2: int, l: float) -> None:
        self.elem_dofs.append(np.array([id1, id2], dtype=np.int64))
        self.elem_mats.append(_conductance_mat(l, self.inp_eps))

    def build_block(self, block_size: int, central: bool, l: float) -> None:
        """One square resistor block (buildBlock, graph.cpp:39-115)."""
        node_id = self.node_id
        for _ in range(block_size):          # rows
            for j in range(block_size - 1):
                self.add_element(node_id + j, node_id + j + 1, l)
            node_id += block_size
        nid = node_id - 1
        for _ in range(block_size):          # columns
            for j in range(block_size - 1):
                self.add_element(nid - j * block_size,
                                 nid - (j + 1) * block_size, l)
            nid -= 1
        self.node_id = node_id

        nid = node_id - 1
        down = sorted(nid - i for i in range(block_size))
        right = sorted(nid - i * block_size for i in range(block_size))
        left = sorted(nid - i * block_size - (block_size - 1)
                      for i in range(block_size))
        up = sorted(nid - (block_size - 1) * block_size - i
                    for i in range(block_size))
        border = (up, right, down, left)
        self.borders.append(border)
        if central:  # fake central level = 4 identical blocks
            self.borders.extend([border, border, border])

        if self.no_ground:
            return
        for side in (up, right, down, left):
            for node in side:
                self.add_element(node, 0, l)


def get_input(args: str = "") -> ElementMesh:
    opt = _grid.parse_args(args, {
        "size": int, "level": int, "weakScaling": int, "inpEps": float,
        "noGround": bool, "verbose": bool, "debug": bool,
    })
    size = opt.get("size", 4)
    level = opt.get("level", 1)
    weak = opt.get("weakScaling", 1)
    inp_eps = opt.get("inpEps", 0.0001)
    no_ground = opt.get("noGround", False)

    block_size = int(math.sqrt(size * weak))
    b = _Builder(inp_eps, no_ground)
    b.build_block(block_size, central=True, l=1.0)

    for l in range(1, level + 1):
        for _ in range(4):  # each level = 4 blocks (up, right, down, left)
            b.build_block(block_size, central=False, l=float(l + 1))

        for blk in range(4):  # connect horizontally within level l
            nxt = (blk + 1) % 4
            before = b.borders[4 * l + blk]
            after = b.borders[4 * l + nxt]
            # (up,right,down,left) = indices (0,1,2,3); pairing per graph.cpp
            src = before[{0: 1, 1: 2, 2: 3, 3: 0}[blk]]
            dst = after[{0: 0, 1: 1, 2: 2, 3: 3}[blk]]
            for a, c in zip(src, dst):
                b.add_element(a, c, 0.5 * (l + 1.0))

        for blk in range(4):  # connect vertically to level l-1
            src = b.borders[4 * (l - 1) + blk][{0: 0, 1: 1, 2: 2, 3: 3}[blk]]
            dst = b.borders[4 * l + blk][{0: 2, 1: 3, 2: 0, 3: 1}[blk]]
            for a, c in zip(src, dst):
                b.add_element(a, c, 0.5 * (l + 1.0))

    return from_lists(b.elem_dofs, b.elem_mats)
