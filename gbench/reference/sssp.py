"""The SSSP reference: Bellman-Ford over the whole weighted edge list, plain
PyTorch on the graph's device.

Each pass relaxes every stored edge (row, col) with weight w, chunk by
chunk (`graphs.chunks`): d[row] = min(d[row], d[col] + w), a scatter_reduce
amin. Passes repeat until one moves no distance. float32 throughout, as
the program computes; with integer weights every path sum is exact, and
FLT_MAX + w rounds back to FLT_MAX, so an unreached vertex stays at the
sentinel. No frontier, no direction choice and no schedule: the answer
alone. Distances follow the program's convention: 0 at the source, FLT_MAX
where the source does not reach. `dtype` computes it in a narrower format
instead, each candidate sum rounded to it, for the readings that set the
check's limit.
"""
from __future__ import annotations

import torch

from gbench.graphs import chunks
from gbench.weighted import WeightedGraph

FLT_MAX = float(torch.finfo(torch.float32).max)


def _passes(g: WeightedGraph, root: int, dtype=torch.float32):
    """The distances after each pass that moved one, the first being the
    source alone: a generator that ends at the fixed point. Each candidate
    d[col] + w is rounded to `dtype`: the float32 sum of two such integers
    is exact, so the rounding is `dtype`'s own addition. FLT_MAX + w rounds
    to FLT_MAX or past it, so the sentinel stays."""
    d = torch.full((g.n,), FLT_MAX, dtype=torch.float32, device=g.rows.device)
    d[root] = 0.0
    yield d
    while True:
        before = d.clone()
        for s, e in chunks(g.m):
            cand = (d.index_select(0, g.cols[s:e]) + g.w[s:e]).to(
                dtype).float()
            d.scatter_reduce_(0, g.rows[s:e].long(), cand, reduce="amin")
        if torch.equal(d, before):
            return
        yield d.clone()


def distances(g: WeightedGraph, root: int,
              dtype=torch.float32) -> torch.Tensor:
    """float32 (n,) shortest-path distances from `root`, computed in
    `dtype`."""
    for d in _passes(g, root, dtype):
        pass
    return d


def last_pass_undone(g: WeightedGraph, root: int) -> torch.Tensor:
    """The control: the distances before the last pass that moved one, as
    a Bellman-Ford would leave them that stopped one relaxation short."""
    out = []
    for d in _passes(g, root):
        out = (out + [d])[-2:]
    return out[0]
