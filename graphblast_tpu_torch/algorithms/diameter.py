"""Pseudo-diameter by BFS sweeps over a source range (counterpart of
graphblast_tpu/algorithms/diameter.py; reference:
graphblas/algorithm/diameter.hpp:14-53)."""
from __future__ import annotations

from ..descriptor import BFS_TUNED, Descriptor
from ..matrix import Matrix
from .bfs import _bfs_levels, bfs_pull_plan


def diameter(A: Matrix, s_start: int, s_end: int,
             desc: Descriptor = BFS_TUNED) -> tuple:
    """(the largest eccentricity, its source) over sources [s_start,
    s_end): the fused BFS from each source, its largest level − 1 (levels
    are 1-based), ties to the first source, and (0, -1) when no source
    reaches a neighbour, as the JAX package returns them. One host read of
    the largest level a source; the bitmap plan is built once (the JAX call
    takes none: the levels are the same)."""
    plan = bfs_pull_plan(A, desc)
    best, best_s = 0, -1
    for s in range(s_start, s_end):
        ecc = int(_bfs_levels(A, s, desc, plan, stepped=False).max()) - 1
        if ecc > best:
            best, best_s = ecc, s
    return best, best_s
