"""A run with the timed path broken underneath comes out not correct: the
harness drives everything but its look for a card, on the CPU, with one
fault planted in the program at a time. One chip: no exchange between
chips to leave out. The program counts its value pulls on the card alone;
here `count_value_pulls` counts the plain version's calls in the same
counter, so that PageRank's check of the iterations runs too."""
import importlib

import pytest
import torch

from gbench import harness
from gbench_tiny import make_root


@pytest.fixture(scope="module")
def root_17(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("gbench_17"), scale=17)


def _bfs_step_unchanged(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.bfs")

    def step(A, v, f, it, **kw):     # labels the frontier, finds nothing
        mod._assign_levels(v, f, it)
        return v, f, torch.tensor(0), False

    mp.setattr(mod, "_bfs_step", step)


def _bfs_half_left_out(mp):
    from graphblast_tpu_torch.ops import dispatch

    inner = dispatch.spmv_bitmap_pull

    def pull(plan, words):           # the pull's odd rows left out
        y = inner(plan, words)
        y[1::2] = 0
        return y

    mp.setattr(dispatch, "spmv_bitmap_pull", pull)


def _bfs_answer_altered(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.bfs")

    inner = mod.dense_result

    def result(n, arr):
        arr = arr.clone()
        arr[int(torch.nonzero(arr).flatten()[-1])] += 1
        return inner(n, arr)

    mp.setattr(mod, "dense_result", result)


def count_value_pulls(mp):
    from graphblast_tpu_torch.ops.kernels import value_pull

    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")
    inner = mod.spmv_value_pull

    def pull(plan, x):
        value_pull.spmv_value_pull.launches += 1
        return inner(plan, x)

    mp.setattr(mod, "spmv_value_pull", pull)


def _pr_step_unchanged(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")

    mp.setattr(mod, "_pr_step", lambda A, p, alpha, plan: (p, torch.zeros(())))


def _pr_half_left_out(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")

    inner = mod.spmv_value_pull

    def pull(plan, x):
        y = inner(plan, x)
        y[1::2] = 0
        return y

    mp.setattr(mod, "spmv_value_pull", pull)


def _pr_answer_altered(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")

    inner = mod.dense_result

    def result(n, arr):
        arr = arr.clone()
        arr[0] += 10.0 / n
        return inner(n, arr)

    mp.setattr(mod, "dense_result", result)


def _pr_previous_iterate(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")
    inner_step, inner = mod._pr_step, mod._pr_fused
    seen = []

    def step(A, p, alpha, plan):     # records each iteration's input
        seen.append(p)
        return inner_step(A, p, alpha, plan)

    def fused(A, plan, **kw):        # every iteration run, p_{K-1} returned
        seen.clear()
        _, it, err = inner(A, plan, **kw)
        return seen[-1], it, err

    mp.setattr(mod, "_pr_step", step)
    mp.setattr(mod, "_pr_fused", fused)


def _pr_one_iteration_short(mp):
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.pr")
    inner = mod._pr_fused
    stops = []

    def fused(A, plan, *, max_niter, **kw):   # stops after K - 1
        if not stops:
            stops.append(inner(A, plan, max_niter=max_niter, **kw)[1])
        return inner(A, plan, max_niter=stops[0] - 1, **kw)

    mp.setattr(mod, "_pr_fused", fused)


# returning p_{K-1} is caught by its distance to p_K, which outgrows the
# limit only with the graph: at scale 10 it reads 5.1e-06, at 17 4.2e-05,
# at 25 on the card 2.7e-04
AT_SCALE_17 = {_pr_previous_iterate}

FAULTS = {"kron25-bfs": [_bfs_step_unchanged, _bfs_half_left_out,
                         _bfs_answer_altered],
          "urand25-bfs": [_bfs_step_unchanged, _bfs_half_left_out,
                          _bfs_answer_altered],
          "kron25-pr": [_pr_step_unchanged, _pr_half_left_out,
                        _pr_answer_altered, _pr_previous_iterate,
                        _pr_one_iteration_short]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
@pytest.mark.parametrize("trace", [0, 1])
def test_fault_is_not_correct(tiny_root, root_17, monkeypatch, cell, fault,
                              trace):
    root = root_17 if fault in AT_SCALE_17 else tiny_root
    if cell.endswith("-pr"):
        count_value_pulls(monkeypatch)
    fault(monkeypatch)
    out = harness.run_cell(cell, 2**31 + 21, 0.2, trace, "cpu", root=root)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_pr_runs_the_reference_stop(tiny_root, monkeypatch, trace):
    """With its value pulls counted, the sound program runs as many
    iterations a call as the float64 loop: the check compares the count."""
    count_value_pulls(monkeypatch)
    out = harness.run_cell("kron25-pr", 2**31 + 21, 0.2, trace, "cpu",
                           root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["checks"]["pr_iters_off"]["value"] == 0
