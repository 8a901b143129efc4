"""The benchmark's own graph arithmetic, in plain PyTorch on any device.

A generator hands over directed edge lists (u, v); `canonical` makes them
the undirected, loop-free, duplicate-free graph that GAP and Graph500
measure: both directions of every edge, sorted by (row, col), ids int32.
The same arrays go to the program and to the references. Nothing here
imports the program.
"""
from __future__ import annotations

import dataclasses

import torch

# edges a chunk of the chunked passes over the edge list: about 1.5 GB of
# temporaries a pass at its widest
CHUNK = 1 << 27


@dataclasses.dataclass
class Graph:
    """An undirected graph as the benchmark holds it: `rows`, `cols` int32
    (m,), both directions of each edge, sorted by (row, col), no self-loop,
    no duplicate; `n` vertices; `ptr` int64 (n + 1,) the CSR row offsets;
    `deg` int64 (n,) the stored edges of each row."""

    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor
    deg: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.rows.shape[0])


def canonical(u: torch.Tensor, v: torch.Tensor, n: int) -> Graph:
    """The graph of the directed edge list (u, v) with ids in [0, n):
    symmetrized, self-loops and duplicates dropped, sorted by (row, col).
    Frees u and v's storage when the caller holds no other reference."""
    if n & (n - 1) or n > 1 << 31:
        raise ValueError(f"n = {n}: the key packs ids of a power of two "
                         "vertices, at most 2^31")
    shift = max(n.bit_length() - 1, 1)
    keep = u != v
    u, v = u[keep].long(), v[keep].long()
    del keep
    key = torch.cat([(u << shift) | v, (v << shift) | u])
    del u, v
    key = torch.sort(key).values
    first = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    if key.shape[0] > 1:
        first[1:] = key[1:] != key[:-1]
    key = key[first]
    del first
    rows = (key >> shift).to(torch.int32)
    cols = (key & (n - 1)).to(torch.int32)
    del key
    deg = torch.bincount(rows, minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(deg, 0, out=ptr[1:])
    return Graph(n, rows, cols, ptr, deg)


def chunks(m: int, chunk: int = CHUNK):
    """(start, end) of each chunk of range(m)."""
    for s in range(0, m, chunk):
        yield s, min(s + chunk, m)


def components(g: Graph) -> torch.Tensor:
    """Each vertex's connected-component label (the least vertex id of its
    component, int64 (n,)): min-label propagation over the edge list with
    pointer jumping, until no label moves."""
    label = torch.arange(g.n, dtype=torch.int64, device=g.rows.device)
    while True:
        new = label.clone()
        for s, e in chunks(g.m):
            new.scatter_reduce_(0, g.rows[s:e].long(),
                                label[g.cols[s:e].long()], reduce="amin")
        while True:   # jump to the label's label until it holds still
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            return label
        label = new


def component_edges(g: Graph, label: torch.Tensor) -> torch.Tensor:
    """For each vertex, the stored edges of its component (int64 (n,)): a
    BFS from it reaches the component and traverses these edges."""
    per_label = torch.zeros(g.n, dtype=torch.int64, device=label.device)
    per_label.index_add_(0, label, g.deg)
    return per_label[label]
