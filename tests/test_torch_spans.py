"""The port's own spans and counters (`utils/profiling.annotate`, the BFS
and PageRank loops, `ops/dispatch.mxv_dual`) on the CPU, with no JAX.

`annotate` is one shared no-op where no profiler runs; under one it records
a host op ("cpu_op" in the Chrome trace, never a user annotation, of which
the profiler makes a device-side copy on a card). The BFS loop records
"gb.bfs.iter" an iteration, holding its "gb.bfs.read" and one "gb.push" or
"gb.pull"; PageRank "gb.pr.iter" holding "gb.pr.read". The push's counters
on `mxv_dual` equal a plain reckoning from the levels of the same run (the
bitmap push's lanes) or from each call's frontier (the slices and the
workspace of a valued push).
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphblast_tpu_torch as gt
from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan
from graphblast_tpu_torch.io.rmat import rmat_matrix
from graphblast_tpu_torch.ops import dispatch
from graphblast_tpu_torch.ops.kernels.bitmap_push import EDGES_PER_BLOCK
from graphblast_tpu_torch.utils import profiling

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")
COUNTERS = ("push_edges", "push_lanes", "top_tier_pushes", "bitmap_pushes")
# the modules: the package's names `bfs` and `sssp` are the functions
bfs_mod = importlib.import_module("graphblast_tpu_torch.algorithms.bfs")
sssp_mod = importlib.import_module("graphblast_tpu_torch.algorithms.sssp")


@pytest.fixture(scope="module")
def rmat10():
    return rmat_matrix(10, 16, seed=1, device="cpu")


@pytest.fixture(scope="module")
def chesapeake():
    return gt.Matrix.from_mtx(CHESAPEAKE, device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _spans(prof, name):
    return [e for e in prof.events() if e.name == name]


def _children(ev, name):
    return [c for c in ev.cpu_children if c.name == name]


def test_annotate_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = profiling.annotate("gb.a")
    assert profiling.annotate("gb.b") is first
    with first:
        with profiling.annotate("gb.c"):     # nests and re-enters
            pass


def test_annotate_records_a_host_op_under_a_profiler(tmp_path):
    prof, _ = _profiled(lambda: _nested_spans())
    (outer,) = _spans(prof, "gb.outer")
    assert [c.name for c in outer.cpu_children] == ["gb.inner"]
    assert not outer.is_user_annotation
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat") for e in
            json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("gb.")}
    assert cats == {"gb.outer": "cpu_op", "gb.inner": "cpu_op"}


def _nested_spans():
    with profiling.annotate("gb.outer"):
        with profiling.annotate("gb.inner"):
            torch.ones(4).sum()


def test_annotate_without_the_fast_range_is_the_no_op(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    prof, span = _profiled(lambda: profiling.annotate("gb.gone"))
    assert span is profiling.annotate("gb.other")
    assert not _spans(prof, "gb.gone")


@pytest.mark.parametrize("graph,source", [("chesapeake", 0),
                                          ("rmat10", 0), ("rmat10", 517)])
@pytest.mark.parametrize("mode", ["fused", "stepped"])
def test_bfs_spans_one_an_iteration(request, monkeypatch, graph, source,
                                    mode):
    """A PUSHPULL bfs(): one "gb.bfs.iter" an iteration, each holding one
    "gb.bfs.read", one "gb.dispatch.read" and the "gb.push" or "gb.pull"
    of its mxv_dual, in the direction that call ran."""
    A = request.getfixturevalue(graph)
    ran = []
    inner = bfs_mod.mxv_dual

    def recording(*args, **kw):
        out = inner(*args, **kw)
        ran.append("gb.push" if out[1] else "gb.pull")
        return out

    monkeypatch.setattr(bfs_mod, "mxv_dual", recording)
    prof, v = _profiled(lambda: gt.algorithms.bfs(A, source, mode=mode))
    iters = sorted(_spans(prof, "gb.bfs.iter"),
                   key=lambda e: e.time_range.start)
    assert len(iters) == int(v.to_numpy().max()) == len(ran)
    assert "gb.push" in ran
    for ev, direction in zip(iters, ran):
        assert len(_children(ev, "gb.bfs.read")) == 1
        assert len(_children(ev, "gb.dispatch.read")) == 1
        assert [c.name for c in ev.cpu_children
                if c.name in ("gb.push", "gb.pull")] == [direction]
    for name in ("gb.bfs.iter", "gb.bfs.read", "gb.dispatch.read",
                 "gb.push", "gb.pull"):
        assert all(not e.is_user_annotation for e in _spans(prof, name))


def test_pr_spans_one_an_iteration(chesapeake):
    """pr(): one "gb.pr.iter" an iteration, each holding one
    "gb.pr.read"; as many as the loop runs."""
    prof, _ = _profiled(lambda: gt.algorithms.pr(chesapeake, eps=1e-6))
    _, iters, _ = _pr_fused(chesapeake, prepare_pr_plan(chesapeake),
                            alpha=0.85, eps=1e-6,
                            max_niter=gt.DEFAULT.max_niter)
    spans = _spans(prof, "gb.pr.iter")
    assert 1 < len(spans) == iters
    assert all(len(_children(e, "gb.pr.read")) == 1 and
               not e.is_user_annotation for e in spans)
    assert len(_spans(prof, "gb.pr.read")) == iters


def test_push_counters_match_a_plain_reckoning(rmat10):
    """PUSHONLY BFS from a few roots: every iteration pushes the frontier
    of its level on the bitmap push, so Σ frontier degree, Σ lanes (the
    degree total in whole blocks of EDGES_PER_BLOCK edges), the pushes
    whose lanes reached edge_cap and the bitmap pushes follow from the
    levels. The roots give pushes of several block counts."""
    A = rmat10
    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PUSHONLY)
    deg = np.diff(A.row_ptr.numpy().astype(np.int64))[:A.nrows]
    before = [getattr(dispatch.mxv_dual, c) for c in COUNTERS]
    want, blocks = [0, 0, 0, 0], set()
    for source in range(0, A.nrows, 64):
        levels = gt.algorithms.bfs(A, source, desc).to_numpy()
        for it in range(1, int(levels.max()) + 1):
            total = int(deg[levels == it].sum())
            lanes = -(-total // EDGES_PER_BLOCK) * EDGES_PER_BLOCK
            blocks.add(lanes // EDGES_PER_BLOCK)
            want[0] += total
            want[1] += lanes
            want[2] += lanes >= A.nnz_pad     # edge_cap
            want[3] += 1
    got = [getattr(dispatch.mxv_dual, c) - b
           for c, b in zip(COUNTERS, before)]
    assert len(blocks) > 2
    assert got == want


def test_push_counters_reckon_the_tiers_of_a_valued_push(monkeypatch,
                                                         rmat10):
    """Valued pushes, reckoned from each call's frontier. PUSHONLY SSSP
    pushes values under MinimumPlus, so its pushes run as scatter pushes of
    one lane an edge over slices of at most edge_cap / 8 edges (rounded up
    to 1,024): Σ frontier degree, and as many lanes; a push counts as
    sliced where its degree total passes that. PUSHONLY BFS over the
    frontier's values takes the workspace push: its lanes are the degree
    total or the frontier's count, whichever is more, rounded up to 1,024
    and at most edge_cap. A push counts as a top-tier push where its lanes
    reach edge_cap, and none as a bitmap push. The roots give frontiers on
    both sides of the slices' bound and workspaces of several sizes."""
    A = rmat10
    edge_cap = A.nnz_pad
    deg = np.diff(A.row_ptr.numpy().astype(np.int64))[:A.nrows]
    slice_max = min(edge_cap, max(-(-(edge_cap // 8) // 1024) * 1024, 1024))
    want, sizes, sliced = [0, 0, 0, 0], set(), [0, 0]

    def recording(mod, valued_bfs):
        inner = mod.mxv_dual

        def call(M, f, *args, **kw):
            front = f.dense.numpy() != kw["identity"]
            total = int(deg[front].sum())
            if valued_bfs:
                lanes = min(edge_cap, max(-(-max(total, int(front.sum()))
                                            // 1024) * 1024, 1024))
                sizes.add(lanes)
            else:
                lanes = total
                sliced[total > slice_max] += 1
            want[0] += total
            want[1] += lanes
            want[2] += lanes >= edge_cap
            return inner(M, f, *args, **kw)

        monkeypatch.setattr(mod, "mxv_dual", call)

    recording(sssp_mod, False)
    recording(bfs_mod, True)
    before = [getattr(dispatch.mxv_dual, c) for c in COUNTERS]
    sliced_before = dispatch.mxv_dual.sliced_pushes
    hub = int(np.argmax(deg))
    for source in [hub] + list(range(0, A.nrows, 128)):
        gt.algorithms.sssp(A, source, gt.DEFAULT.replace(
            mxv_mode=gt.Direction.PUSHONLY))
        gt.algorithms.bfs(A, source, gt.BFS_TUNED.replace(
            structure_only=False, mxv_mode=gt.Direction.PUSHONLY))
    got = [getattr(dispatch.mxv_dual, c) - b
           for c, b in zip(COUNTERS, before)]
    assert len(sizes) > 2 and sliced[0] > 0
    assert got == want
    assert dispatch.mxv_dual.sliced_pushes - sliced_before == sliced[1] > 0


@pytest.mark.parametrize("case", ["bfs", "bfs_values", "sssp"])
def test_bitmap_pushes_count_the_structure_only_pushes(monkeypatch, rmat10,
                                                       case):
    """mxv_dual.bitmap_pushes counts every push of a structure-only BFS,
    PUSHONLY and PUSHPULL, and no push of BFS over the frontier's values
    or of SSSP."""
    A = rmat10
    hub = int(np.argmax(np.diff(A.row_ptr.numpy())[:A.nrows]))
    mod = sssp_mod if case == "sssp" else bfs_mod
    pushes = []
    inner = mod.mxv_dual

    def recording(*args, **kw):
        out = inner(*args, **kw)
        pushes.append(out[1])
        return out

    monkeypatch.setattr(mod, "mxv_dual", recording)
    before = dispatch.mxv_dual.bitmap_pushes
    if case == "sssp":
        gt.algorithms.sssp(A, hub)
        gt.algorithms.sssp(A, hub, gt.DEFAULT.replace(
            mxv_mode=gt.Direction.PUSHONLY))
        want = 0
    else:
        desc = gt.BFS_TUNED.replace(structure_only=case != "bfs_values")
        levels = gt.algorithms.bfs(A, hub, desc)
        np.testing.assert_array_equal(levels.to_numpy(),
                                      gt.algorithms.bfs_cpu(A, hub))
        assert 0 < sum(pushes) < len(pushes)
        gt.algorithms.bfs(A, hub, desc.replace(
            mxv_mode=gt.Direction.PUSHONLY))
        want = sum(pushes) if case == "bfs" else 0
    assert sum(pushes) > 0
    assert dispatch.mxv_dual.bitmap_pushes - before == want


def test_pulls_move_no_push_counter(chesapeake):
    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY)
    before = [getattr(dispatch.mxv_dual, c) for c in COUNTERS]
    prof, v = _profiled(lambda: gt.algorithms.bfs(chesapeake, 0, desc))
    assert [getattr(dispatch.mxv_dual, c) for c in COUNTERS] == before
    assert len(_spans(prof, "gb.pull")) == int(v.to_numpy().max())
    assert not _spans(prof, "gb.push") and not _spans(prof,
                                                      "gb.dispatch.read")
