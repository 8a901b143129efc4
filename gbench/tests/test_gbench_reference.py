"""The references agree with the port's CPU results at a small scale, and
the controls do not."""
import json
import os

import pytest
import torch

from gbench import harness
from gbench.reference import bfs as ref_bfs
from gbench.reference import pr as ref_pr


def _graph(scale=9, seed=3):
    with open(os.path.join(harness.ROOT, "gbench", "configs",
                           "kron25.json")) as f:
        cfg = json.load(f)
    cfg["scale"] = scale
    gen = torch.Generator()
    gen.manual_seed(seed)
    mod = harness.load_module(harness.ROOT, "generators", "kron")
    return mod.generate(cfg, gen, torch.device("cpu"))


def _matrix(g):
    from graphblast_tpu_torch.matrix import Matrix

    return Matrix.from_device_coo(g.rows, g.cols,
                                  torch.ones(g.m, dtype=torch.float32),
                                  g.n, g.n)


@pytest.mark.parametrize("pick", [0, 7, 30])
def test_bfs_reference_equals_port(pick):
    from graphblast_tpu_torch.algorithms.bfs import bfs

    g = _graph()
    root = int(torch.nonzero(g.deg > 0).flatten()[pick])
    want = ref_bfs.levels(g, root)
    got = bfs(_matrix(g), root).dense
    assert torch.equal(got, want.to(torch.float32))
    dropped = ref_bfs.levels_last_dropped(g, root)
    assert int((dropped != want).sum()) > 0


def test_pr_reference_equals_port():
    from graphblast_tpu_torch.algorithms.pr import pr, prepare_pr_matrix

    g = _graph()
    its, stop, errs = ref_pr.iterates(g, 0.85, 1e-6, 10000)
    got = pr(prepare_pr_matrix(_matrix(g), 0.85), 0.85, 1e-6,
             prepared=True).dense
    # the float64 loop stops where the port's float32 loop stops, clear of
    # float32 rounding at both boundaries
    assert stop > 3 and ref_pr.stops(stop, errs, 1e-6) == [stop]
    assert errs[stop - 1] > 1e-6 >= errs[stop]
    d = {k: ref_pr.rel_l1(got, p) for k, p in its.items()}
    assert d[stop] < 1e-5
    # nearest the iterate of its own stop, by a wide margin
    assert 10 * d[stop] < min(d[stop - 1], d[stop + 1])
    ctl = ref_pr.control(g, 0.85, 1e-6, stop + 1)
    assert ref_pr.rel_l1(ctl, its[stop]) > 1e-3


def test_pr_stops_near_eps():
    eps = 1e-6
    far = {4: 3e-6, 5: 5e-7, 6: 2e-7}
    assert ref_pr.stops(5, far, eps) == [5]
    above = {**far, 4: eps * (1 + ref_pr.ROUNDING / 2)}
    assert ref_pr.stops(5, above, eps) == [4, 5]
    below = {**far, 5: eps * (1 - ref_pr.ROUNDING / 2)}
    assert ref_pr.stops(5, below, eps) == [5, 6]
    assert ref_pr.stops(1, {1: 5e-7, 2: 1e-7}, eps) == [1]
