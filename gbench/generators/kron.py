"""Graph500's Kronecker generator (GAP's `kron`), on the device from the seed.

Each of the edge_factor * 2^scale edges picks one quadrant of the adjacency
matrix a bit level at a time, with probabilities A, B, C and D = 1 - A - B -
C, as Graph500's reference `kronecker_generator` does: the row bit is set
with probability C + D = 1 - (A + B), and the column bit then with D / (C +
D) where the row bit is set and B / (A + B) where it is not. Vertex ids are then
permuted at random, as Graph500 and GAP do, so that an id says nothing of a
vertex's degree. `gbench.graphs.canonical` makes the result undirected,
loop-free and duplicate-free.
"""
from __future__ import annotations

import torch

from gbench.graphs import Graph, canonical


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    """The directed edge list (u, v), int32 on `device`, and n."""
    scale, m = int(cfg["scale"]), int(cfg["edge_factor"]) << int(cfg["scale"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    u = torch.zeros(m, dtype=torch.int32, device=device)
    v = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        del thresh
        u |= ii.to(torch.int32) << bit
        v |= jj.to(torch.int32) << bit
        del ii, jj
    n = 1 << scale
    perm = torch.randperm(n, generator=gen, device=device, dtype=torch.int32)
    u = perm[u.long()]
    v = perm[v.long()]
    return u, v, n


def generate(cfg: dict, gen: torch.Generator, device) -> Graph:
    # no local keeps the int32 lists alive while canonical() widens them
    return canonical(*edges(cfg, gen, device))
