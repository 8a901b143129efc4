"""GAP's `urand` (Erdos-Renyi), on the device from the seed: edge_factor *
2^scale edges, both ends uniform over the 2^scale vertices.
`gbench.graphs.canonical` makes the result undirected, loop-free and
duplicate-free.
"""
from __future__ import annotations

import torch

from gbench.graphs import CHUNK, Graph, canonical


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    """The directed edge list (u, v), int32 on `device`, and n."""
    n = 1 << int(cfg["scale"])
    m = int(cfg["edge_factor"]) * n
    u = torch.empty(m, dtype=torch.int32, device=device)
    v = torch.empty(m, dtype=torch.int32, device=device)
    for s in range(0, m, CHUNK):
        e = min(s + CHUNK, m)
        u[s:e] = torch.randint(0, n, (e - s,), generator=gen, device=device)
        v[s:e] = torch.randint(0, n, (e - s,), generator=gen, device=device)
    return u, v, n


def generate(cfg: dict, gen: torch.Generator, device) -> Graph:
    # no local keeps the int32 lists alive while canonical() widens them
    return canonical(*edges(cfg, gen, device))
