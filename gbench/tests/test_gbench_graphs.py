"""The generators and the canonical graph: deterministic per seed,
symmetric, no self-loop, no duplicate, sorted by (row, col)."""
import json
import os

import pytest
import torch

from gbench import graphs, harness

REPO = harness.ROOT


def _generate(name: str, seed: int, scale: int = 9):
    with open(os.path.join(REPO, "gbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["scale"] = scale
    gen = torch.Generator()
    gen.manual_seed(seed)
    mod = harness.load_module(REPO, "generators", cfg["generator"])
    return mod.generate(cfg, gen, torch.device("cpu"))


@pytest.mark.parametrize("name", ["kron25", "urand25"])
def test_deterministic_per_seed(name):
    a, b = _generate(name, 5), _generate(name, 5)
    c = _generate(name, 6)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.cols, b.cols)
    assert not (a.m == c.m and torch.equal(a.rows, c.rows)
                and torch.equal(a.cols, c.cols))


@pytest.mark.parametrize("name", ["kron25", "urand25"])
def test_canonical(name):
    g = _generate(name, 2**31 + 11)
    assert g.rows.dtype == torch.int32 and g.cols.dtype == torch.int32
    assert not bool((g.rows == g.cols).any())
    key = g.rows.long() * g.n + g.cols.long()
    assert bool((key[1:] > key[:-1]).all())          # sorted, no duplicate
    back = torch.sort(g.cols.long() * g.n + g.rows.long()).values
    assert torch.equal(back, key)                    # symmetric
    assert torch.equal(g.ptr[1:] - g.ptr[:-1], g.deg)
    assert int(g.ptr[-1]) == g.m


def test_canonical_by_hand():
    u = torch.tensor([0, 1, 2, 2, 3, 1], dtype=torch.int32)
    v = torch.tensor([1, 0, 2, 3, 2, 3], dtype=torch.int32)
    g = graphs.canonical(u, v, 4)
    pairs = list(zip(g.rows.tolist(), g.cols.tolist()))
    assert pairs == [(0, 1), (1, 0), (1, 3), (2, 3), (3, 1), (3, 2)]
    assert g.deg.tolist() == [1, 2, 1, 2]


def test_components_and_their_edges():
    # two triangles' worth: a path 0-1-2 and an edge 4-5; 3 and 6, 7 alone
    u = torch.tensor([0, 1, 4], dtype=torch.int32)
    v = torch.tensor([1, 2, 5], dtype=torch.int32)
    g = graphs.canonical(u, v, 8)
    label = graphs.components(g)
    assert label.tolist() == [0, 0, 0, 3, 4, 4, 6, 7]
    assert graphs.component_edges(g, label).tolist() == [4, 4, 4, 0, 2, 2, 0, 0]
