"""The port's SSSP on GAP-style weighted graphs, against the benchmark's
plain reference, on the CPU with no JAX: the weight draw of the `kron25w`
configuration (`gbench/weighted.py`), `sssp()` in every direction against
`gbench/reference/sssp.py` at 2^10 vertices, the scatter push over slices
of the frontier that `mxv_dual` runs for a valued Min or Max push,
against the MERGE sort push in one workspace, its push of one lane an edge
against the SIMPLE push in a workspace, and the SSSP loop's spans.

Every comparison is exact: integer weights make every path sum exact in
float32, and min does not depend on the order it meets its operands.
"""
import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphblast_tpu_torch as gt
from gbench import harness
from gbench.reference import sssp as ref
from gbench.weighted import pair_weights
from graphblast_tpu_torch.io.rmat import rmat_matrix
from graphblast_tpu_torch.matrix import Matrix
from graphblast_tpu_torch.ops import dispatch
from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual
from graphblast_tpu_torch.ops.kernels.monoid_pull import FLT_MAX
from graphblast_tpu_torch.ops.spmspv import spmspv_push, spmspv_push_exact
from graphblast_tpu_torch.semiring import (MaximumMultipliesSemiring,
                                           MinimumPlusSemiring)

sssp_mod = importlib.import_module("graphblast_tpu_torch.algorithms.sssp")
SEED = 27491095


def _kron10w():
    cfg = harness.load_json(harness.ROOT + "/gbench/configs/kron25w.json")
    cfg["scale"] = 10
    gen = harness.load_module(harness.ROOT, "generators", cfg["generator"])
    return harness.draw_graph(gen, cfg, "cpu")


@pytest.fixture(scope="module")
def kron10w():
    g = _kron10w()
    return g, Matrix.from_device_coo(g.rows, g.cols, g.w, g.n, g.n)


def test_weights_are_symmetric_integers_in_range_and_repeat(kron10w):
    g, _ = kron10w
    w = g.w
    assert w.dtype == torch.float32
    assert torch.equal(w, w.round())
    assert int(w.min()) == 1 and int(w.max()) == 255
    assert len(torch.unique(w)) == 255
    # both directions of an edge carry one weight: (row, col) -> w equals
    # (col, row) -> w, found through the transposed key's position
    key = g.rows.long() * g.n + g.cols.long()
    back = torch.searchsorted(key, g.cols.long() * g.n + g.rows.long())
    assert torch.equal(key[back], g.cols.long() * g.n + g.rows.long())
    assert torch.equal(w[back], w)
    # repeatable from the seed, and another seed draws other weights
    assert torch.equal(_kron10w().w, w)
    other = pair_weights(g.rows, g.cols, SEED + 1)
    assert torch.equal(pair_weights(g.rows, g.cols, SEED), w)
    assert (other != w).float().mean() > 0.9


def test_weights_follow_the_unordered_pair():
    a = torch.tensor([5, 9, 0, 1023], dtype=torch.int32)
    b = torch.tensor([9, 5, 1023, 0], dtype=torch.int32)
    w = pair_weights(a, b, SEED)
    assert w[0] == w[1] and w[2] == w[3]
    assert torch.equal(pair_weights(a, b, SEED, 3, 3), torch.full((4,), 3.0))


@pytest.mark.parametrize("mode", ["PUSHPULL", "PUSHONLY", "PULLONLY"])
def test_sssp_equals_the_reference_in_every_direction(kron10w, mode):
    g, A = kron10w
    desc = gt.DEFAULT.replace(mxv_mode=getattr(gt.Direction, mode))
    hub = int(torch.argmax(g.deg))
    roots = [hub] + harness.draw_roots(g, {"roots": 5, "root_min_degree": 1,
                                           "roots_seed": SEED})
    for root in roots:
        got = gt.algorithms.sssp(A, root, desc).dense
        want = ref.distances(g, root)
        assert torch.equal(got, want), (mode, root)
        assert int((want < FLT_MAX).sum()) > 1


def test_sssp_pushes_in_slices_from_the_hub(kron10w):
    """PUSHONLY from the hub: a frontier past the second tier runs in
    more than one slice, and the distances stay the reference's."""
    g, A = kron10w
    desc = gt.DEFAULT.replace(mxv_mode=gt.Direction.PUSHONLY)
    hub = int(torch.argmax(g.deg))
    before = mxv_dual.sliced_pushes
    got = gt.algorithms.sssp(A, hub, desc).dense
    assert mxv_dual.sliced_pushes > before
    assert torch.equal(got, ref.distances(g, hub))


def test_reference_control_leaves_the_last_pass_undone(kron10w):
    g, _ = kron10w
    root = int(torch.argmax(g.deg))
    full, short = ref.distances(g, root), ref.last_pass_undone(g, root)
    assert (short != full).any()
    assert (short >= full).all()


@pytest.fixture(scope="module")
def rmat10_valued():
    A = rmat_matrix(10, 16, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(4)
    m = A.nvals
    rows = torch.repeat_interleave(torch.arange(A.nrows),
                                   torch.diff(A.row_ptr[:A.nrows + 1].long()))
    cols = A.col_ind[:m].long()
    vals = torch.randint(1, 9, (m,), generator=gen).float()
    return Matrix.from_device_coo(rows.int(), cols.int(), vals, A.nrows,
                                  A.ncols)


def _frontier(n, share, seed, semiring):
    gen = torch.Generator().manual_seed(seed)
    ident = semiring.identity(torch.float32).item()
    vals = torch.randint(1, 50, (n,), generator=gen).float()
    keep = torch.rand(n, generator=gen) < share
    return DualFrontier.from_dense(torch.where(keep, vals, ident), ident,
                                   prefer_sparse=True), ident


def _sort_push(A, f, semiring, ident, mask=None, postprocess=None,
               postprocess_sparse=None):
    """The push mxv_dual(A, f, transpose=True) would run on its workspace
    route (`dispatch._push`, as the other valued pushes take it) by the
    MERGE sort push, in one workspace of nnz_pad lanes: (dense, sind, sval,
    nv)."""
    push_csr = A.pull_csr(False)[2:]
    fin = (f.sind, f.sval, f.snvals)
    y, sind, sval, nv = dispatch._push(
        push_csr, fin, A.nnz_pad, True, semiring, ident, A.nrows,
        mask_dense=mask, mask_scmp=False, structure_only=False,
        sort_push=True, postprocess=postprocess,
        postprocess_sparse=postprocess_sparse)
    return y, sind, sval, int(nv)


def _equal_images(got, want):
    y, sind, sval, nv = want
    assert int(got.snvals) == nv > 0
    assert torch.equal(got.dense, y)
    assert torch.equal(got.sind[:nv], sind[:nv])
    assert torch.equal(got.sval[:nv], sval[:nv])


@pytest.mark.parametrize("semiring", [MinimumPlusSemiring,
                                      MaximumMultipliesSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("share,seed", [(0.3, 1), (0.6, 2), (1.0, 3)])
def test_sliced_push_equals_the_whole_push(rmat10_valued, semiring, masked,
                                           share, seed):
    """mxv_dual's scatter push in slices (edge_cap nnz_pad: the frontier
    passes `slice_lanes`) and in one slice (edge_cap 8 · nnz_pad, whose
    slices hold nnz_pad edges) against the MERGE sort push in one
    workspace: the same images, exactly."""
    A = rmat10_valued
    f, ident = _frontier(A.nrows, share, seed, semiring)
    mask = None
    if masked:
        mask = torch.rand(A.nrows, generator=torch.Generator().manual_seed(
            seed + 7)) < 0.7
    deg = torch.diff(A.row_ptr[:A.nrows + 1].long())
    assert int(deg[f.dense != ident].sum()) > dispatch.slice_lanes(A.nnz_pad)
    assert dispatch.slice_lanes(8 * A.nnz_pad) == A.nnz_pad
    kw = dict(identity=ident, transpose=True, mask_dense=mask,
              mode=gt.Direction.PUSHONLY)
    before = mxv_dual.sliced_pushes
    sliced, _ = mxv_dual(A, f, semiring, edge_cap=A.nnz_pad, **kw)
    assert mxv_dual.sliced_pushes == before + 1
    one, _ = mxv_dual(A, f, semiring, edge_cap=8 * A.nnz_pad, **kw)
    assert mxv_dual.sliced_pushes == before + 1
    want = _sort_push(A, f, semiring, ident, mask)
    _equal_images(sliced, want)
    _equal_images(one, want)


def test_sliced_push_runs_the_filter_once(rmat10_valued):
    """SSSP's filter in both forms: the sliced push applies the dense one
    after the merge, the sort push the sparse one; the images agree."""
    A = rmat10_valued
    f, ident = _frontier(A.nrows, 0.5, 5, MinimumPlusSemiring)
    v = torch.randint(1, 60, (A.nrows,),
                      generator=torch.Generator().manual_seed(6)).float()
    kw = dict(identity=ident, transpose=True, mode=gt.Direction.PUSHONLY,
              postprocess=lambda y: torch.where(y < v, y, ident),
              postprocess_sparse=lambda k, y: torch.where(y < v[k.long()], y,
                                                          ident))
    sliced, _ = mxv_dual(A, f, MinimumPlusSemiring, **kw)
    post = {k: kw[k] for k in ("postprocess", "postprocess_sparse")}
    _equal_images(sliced, _sort_push(A, f, MinimumPlusSemiring, ident,
                                     **post))


@pytest.mark.parametrize("semiring", [MinimumPlusSemiring,
                                      MaximumMultipliesSemiring],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_exact_push_equals_the_workspace_scatter_push(rmat10_valued,
                                                      semiring, values,
                                                      split):
    """spmspv_push_exact, one lane an edge, against spmspv_push's SIMPLE
    scatter push in a rounded workspace: the same dense result exactly,
    with frontier values or without (⊗ then reads ones), over a frontier
    that holds degree-0 vertices, whole or as two halves, the second
    scattered into the first's result (`out`)."""
    A = rmat10_valued
    ptr, ind, val = A.pull_csr(False)[2:]
    deg = torch.diff(ptr[:A.nrows + 1].long())
    assert int((deg == 0).sum()) > 0
    gen = torch.Generator().manual_seed(11)
    f_ind = torch.nonzero(torch.rand(A.nrows, generator=gen) < 0.4).flatten()
    f_ind = f_ind.to(torch.int32)
    assert int((deg[f_ind.long()] == 0).sum()) > 0
    f_val = (torch.randint(1, 50, (f_ind.shape[0],), generator=gen).float()
             if values else None)
    edges = int(deg[f_ind.long()].sum())
    want = spmspv_push(ptr, ind, val, f_ind, f_val, f_ind.shape[0], semiring,
                       A.nrows, -(-edges // 1024) * 1024, sort_push=False)
    if split:
        h = f_ind.shape[0] // 2
        halves = [(f_ind[:h], None if f_val is None else f_val[:h]),
                  (f_ind[h:], None if f_val is None else f_val[h:])]
        got = None
        for fi, fv in halves:
            got = spmspv_push_exact(ptr, ind, val, fi, fv,
                                    int(deg[fi.long()].sum()), semiring,
                                    A.nrows, out=got)
    else:
        got = spmspv_push_exact(ptr, ind, val, f_ind, f_val, edges, semiring,
                                A.nrows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [64, 1024, 3000, 10**6])
def test_slice_bounds_cut_the_frontier_greedily(rmat10_valued, lanes):
    """Each slice holds as many frontier slots, in order, as fit `lanes`
    edges (one vertex alone may hold more); together they cover the
    frontier once. A degree total that is not the frontier's raises."""
    A = rmat10_valued
    ptr = A.row_ptr
    deg = torch.diff(ptr[:A.nrows + 1].long()).numpy()
    sind = torch.nonzero(torch.arange(A.nrows) % 3 != 1).flatten().int()
    nv = sind.shape[0]
    pad = torch.cat([sind, torch.full((5,), A.nrows, dtype=torch.int32)])
    d = deg[sind.numpy()]
    bounds = dispatch.slice_bounds(ptr, pad, nv, lanes, int(d.sum()))
    assert bounds[0][0] == 0 and bounds[-1][1] == nv
    for (s, e, edges), nxt in zip(bounds, bounds[1:] + [None]):
        assert edges == int(d[s:e].sum())
        assert edges <= lanes or e - s == 1
        if nxt is not None:
            assert nxt[0] == e and edges + d[e] > lanes
    if len(bounds) > 4:     # more than the 4 steps lanes + 1 edges set
        with pytest.raises(RuntimeError):
            dispatch.slice_bounds(ptr, pad, nv, lanes, lanes + 1)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


@pytest.mark.parametrize("mode", ["PUSHPULL", "PULLONLY"])
def test_sssp_spans_one_a_relaxation(kron10w, mode):
    """sssp(): one "gb.sssp.iter" a relaxation, as many as the loop counts,
    each holding one "gb.sssp.read"; none is a user annotation."""
    g, A = kron10w
    desc = gt.DEFAULT.replace(mxv_mode=getattr(gt.Direction, mode))
    root = int(torch.argmax(g.deg))
    prof, _ = _profiled(lambda: gt.algorithms.sssp(A, root, desc))
    plan = sssp_mod.plan_for_monoid(A, transpose=True)
    _, iters = sssp_mod._sssp_fused(
        A, root, plan, switchpoint=desc.switchpoint, mode=desc.mxv_mode,
        max_niter=desc.max_niter)
    spans = [e for e in prof.events() if e.name == "gb.sssp.iter"]
    assert 1 < len(spans) == iters
    for e in spans:
        assert [c.name for c in e.cpu_children
                if c.name == "gb.sssp.read"] == ["gb.sssp.read"]
        assert not e.is_user_annotation
    reads = [e for e in prof.events() if e.name == "gb.sssp.read"]
    assert len(reads) == iters


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", [MinimumPlusSemiring,
                                      MaximumMultipliesSemiring],
                         ids=lambda s: s.name)
def test_sliced_push_equals_the_whole_push_on_the_card(semiring):
    """The same comparison on the card, at 2^14 vertices, where the slices'
    scatter pushes merge by ⊕ and the sort push sorts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    A = rmat_matrix(14, 16, seed=2, device="cuda")
    f, ident = _frontier(A.nrows, 0.5, 9, semiring)
    f = DualFrontier.from_dense(f.dense.cuda(), ident, prefer_sparse=True)
    kw = dict(identity=ident, transpose=True, mode=gt.Direction.PUSHONLY)
    before = mxv_dual.sliced_pushes
    sliced, _ = mxv_dual(A, f, semiring, **kw)
    one, _ = mxv_dual(A, f, semiring, edge_cap=8 * A.nnz_pad, **kw)
    assert mxv_dual.sliced_pushes == before + 1
    want = _sort_push(A, f, semiring, ident)
    _equal_images(sliced, want)
    _equal_images(one, want)


def test_reference_in_a_narrower_format(kron10w):
    """The readings that set `dist_mismatch_max`'s limit of 0: bfloat16
    holds integers only up to 256 and reads vertices off; float16 holds
    every integer up to 2,048, past this graph's distances, and reads
    none off: both formats' sums of integers are exact there."""
    g, _ = kron10w
    root = int(torch.argmax(g.deg))
    want = ref.distances(g, root)
    assert float(want[want < FLT_MAX].max()) > 256
    half = ref.distances(g, root, torch.bfloat16)
    assert int((half != want).sum()) > 0
    assert torch.equal(ref.distances(g, root, torch.float16), want)
