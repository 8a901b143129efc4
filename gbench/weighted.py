"""A weighted graph as the benchmark holds it, and the draw of its weights.

GAP's weighted graphs (its `sssp` kernel, arXiv:1508.03619) give each
undirected edge one integer weight, uniform in [1, 255]. Here the weight of
the edge {a, b} is a seeded hash of the unordered pair (min, max) and the
graph's seed, so both stored directions carry the same weight, the weights
repeat bit for bit from the seed on any device, and a run draws them again
with the graph. Integer weights below 2^24 keep every path sum exact in
float32. Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import torch

from gbench.graphs import Graph, chunks

M32 = 0xFFFFFFFF
# Mueller's 32-bit integer mixer: each product of a value below 2^32 and
# this constant below 2^31 stays inside int64
_MUL = 0x45D9F3B


@dataclasses.dataclass
class WeightedGraph(Graph):
    """A `Graph` and `w`, float32 (m,): the weight of each stored edge,
    in the order of rows and cols; None once a run has dropped it."""

    w: torch.Tensor = None


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL) & M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & M32
    return x ^ (x >> 16)


def pair_weights(rows: torch.Tensor, cols: torch.Tensor, seed: int,
                 low: int = 1, high: int = 255) -> torch.Tensor:
    """float32 (m,): for each stored edge (row, col), an integer in [low,
    high] drawn as a hash of (min(row, col), max(row, col), seed), the same
    for both directions. Chunked over the edges (`graphs.chunks`)."""
    seed = int(seed) & M32
    span = high - low + 1
    w = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    for s, e in chunks(rows.shape[0]):
        r, c = rows[s:e].long(), cols[s:e].long()
        h = _mix32(torch.minimum(r, c) ^ seed)
        h = _mix32(h ^ torch.maximum(r, c))
        w[s:e] = (h % span + low).to(torch.float32)
    return w

