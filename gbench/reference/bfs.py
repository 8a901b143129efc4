"""The BFS reference: levels by level-synchronous passes over the whole
edge list, plain PyTorch on the graph's device.

Levels follow the program's convention (GraphBLAST's bfs.hpp): the source
1, a vertex first reached in pass k at level k + 1, an unreached vertex 0.
Each pass tests every stored edge (row, col): row joins the next frontier
when col is in the frontier and row is unvisited. No direction choice, no
bitmap and no schedule: the answer alone.
"""
from __future__ import annotations

import torch

from gbench.graphs import Graph, chunks


def levels(g: Graph, root: int) -> torch.Tensor:
    """int32 (n,) BFS levels from `root`."""
    dev = g.rows.device
    level = torch.zeros(g.n, dtype=torch.int32, device=dev)
    frontier = torch.zeros(g.n, dtype=torch.bool, device=dev)
    level[root] = 1
    frontier[root] = True
    depth = 1
    while True:
        nxt = torch.zeros(g.n, dtype=torch.bool, device=dev)
        for s, e in chunks(g.m):
            hit = frontier.index_select(0, g.cols[s:e])
            nxt.index_fill_(0, g.rows[s:e][hit].long(), True)
        nxt &= level == 0
        if not bool(nxt.any()):
            return level
        depth += 1
        level[nxt] = depth
        frontier = nxt


def levels_last_dropped(g: Graph, root: int) -> torch.Tensor:
    """The control: `levels` with the deepest level reported unreached, as
    a BFS would that stops once its frontier has shrunk to a tail."""
    lv = levels(g, root)
    deepest = int(lv.max())
    if deepest > 1:
        lv[lv == deepest] = 0
    return lv
