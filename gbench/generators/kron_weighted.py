"""GAP's weighted `kron` graph (its `sssp` input), on the device from the
seed: the edges of `generators/kron.py` from the same graph_seed, made
canonical, and one integer weight an undirected edge, uniform in the
configuration's [weight_low, weight_high], drawn as a seeded hash of the
unordered pair (`gbench.weighted.pair_weights`)."""
from __future__ import annotations

import os

import torch

from gbench import harness
from gbench.weighted import WeightedGraph, pair_weights

# the root of the checkout this file lies in: kron.py is its sibling
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def generate(cfg: dict, gen: torch.Generator, device) -> WeightedGraph:
    g = harness.load_module(_ROOT, "generators", "kron").generate(
        cfg, gen, device)
    w = pair_weights(g.rows, g.cols, int(cfg["graph_seed"]),
                     int(cfg["weight_low"]), int(cfg["weight_high"]))
    return WeightedGraph(g.n, g.rows, g.cols, g.ptr, g.deg, w)
