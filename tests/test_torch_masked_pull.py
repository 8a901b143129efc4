"""K1's masked entry, the or-pull under BFS's visited mask, on the CPU.

A BitmapPlan with a float32 `mask` makes `spmv_bitmap_pull` the masked
or-pull: 1 where the mask passes at the row and some edge's frontier bit is
set, else 0. On the CPU its plain version expands the open rows' edges
alone; it must equal K1's plain count, `> 0`, and the mask's pass bit for
bit, on CSRs with rows in every bin of the row schedule (a row past
LONG_ROW included). `mxv_dual` must give the same DualFrontier through the
masked plan as through the count and `masked_fill`, and BFS over it the
JAX package's levels. The card's tests (tests/test_torch_cuda.py) take
this file's cases, so it imports JAX only inside the test that needs it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.algorithms.bfs import _initial_frontier
from graphblast_tpu_torch.ops import dispatch
from graphblast_tpu_torch.ops.kernels import bitmap_pull as bp
from graphblast_tpu_torch.ops.kernels import row_schedule as rs
from graphblast_tpu_torch.ops.spmv import mask_pass

T = rs.LONG_ROW


def _every_bin_lengths(rng):
    # empty rows, rows of 1-4, 5-8, 9-16 and 17-32 edges, medium rows and
    # one row past LONG_ROW, shuffled so that the schedule reorders them
    lengths = np.r_[np.zeros(40, np.int64), rng.integers(1, 5, 60),
                    rng.integers(5, 9, 60), rng.integers(9, 17, 60),
                    rng.integers(17, 33, 60), rng.integers(33, 700, 30),
                    [2 * T + 37]]
    return rng.permutation(lengths)


CSRS = {
    "every_bin": _every_bin_lengths,
    "uniform": lambda rng: rng.integers(20, 45, 600),
}


def _csr(name, seed=11):
    """A square CSR (n = n_out = n_in) whose row lengths `CSRS[name]`
    gives, with random column ids: (n, ptr, cols)."""
    rng = np.random.default_rng(seed)
    lengths = CSRS[name](rng)
    n = len(lengths)
    ptr = np.r_[0, np.cumsum(lengths)]
    cols = rng.integers(0, n, int(ptr[-1]))
    return n, ptr, cols


def _bfs_levels(n, ptr, cols, source):
    """Levels of a BFS over the CSR's rows as out-edges (1 at the source,
    0 unreached), in NumPy."""
    level = np.zeros(n, np.int64)
    level[source] = 1
    front = [source]
    it = 1
    while front:
        nxt = set()
        for u in front:
            for v in cols[ptr[u]:ptr[u + 1]]:
                if level[v] == 0:
                    level[v] = it + 1
                    nxt.add(int(v))
        front = sorted(nxt)
        it += 1
    return level


def _frontier(kind, n, ptr, cols):
    """The frontier as float32: the column that most rows hold (a hub), a
    BFS level (level 2 from that hub), or a random 20% of the vertices."""
    hub = int(np.bincount(cols, minlength=n).argmax())
    if kind == "hub":
        return np.eye(1, n, hub, dtype=np.float32)[0]
    if kind == "level":
        f = (_bfs_levels(n, ptr, cols, hub) == 2).astype(np.float32)
        assert f.sum() > 0
        return f
    return (np.random.default_rng(5).random(n) < 0.2).astype(np.float32)


def _mask(density, n):
    """A float32 mask whose nonzeros (levels 1, 2, ...; one -0.0 among the
    zeros) fill `density` of the rows."""
    rng = np.random.default_rng(int(density * 10) + 1)
    mask = np.where(rng.random(n) < density,
                    rng.integers(1, 9, n), 0).astype(np.float32)
    zeros = np.flatnonzero(mask == 0)
    if len(zeros):
        mask[zeros[0]] = -0.0
    return mask


@pytest.mark.parametrize("csr", list(CSRS))
@pytest.mark.parametrize("frontier", ["hub", "level", "random20"])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("scmp", [False, True])
def test_masked_plain_is_the_count_under_the_mask(csr, frontier, density,
                                                  scmp):
    n, ptr, cols = _csr(csr)
    plan = bp.build_plan_bitmap(torch.from_numpy(ptr.astype(np.int32)),
                                torch.from_numpy(cols.astype(np.int32)), n, n)
    if csr == "every_bin":   # rows in each bin, a long one included
        sched = rs.build_schedule(plan.ptr)
        assert all(r > 0 for r in sched.bin_rows)
    words = bp.pack_bitmap(torch.from_numpy(_frontier(frontier, n, ptr,
                                                      cols)))
    mask = torch.from_numpy(_mask(density, n))
    masked = dataclasses.replace(plan, mask=mask, mask_scmp=scmp)
    got = bp.spmv_bitmap_pull_plain(masked, words)
    want = ((bp.spmv_bitmap_pull_plain(plan, words) > 0)
            & mask_pass(mask, scmp)).to(torch.int32)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(bp.spmv_bitmap_pull(masked, words), want)
    # the cached plan keeps K1's counts
    assert plan.mask is None
    if density == (0.0 if scmp else 1.0):
        assert torch.equal(got, (bp.spmv_bitmap_pull_plain(plan, words)
                                 > 0).to(torch.int32))
    if density == (1.0 if scmp else 0.0):
        assert int(got.sum()) == 0


def test_masked_plan_refuses_a_mask_it_cannot_read():
    n, ptr, cols = _csr("uniform")
    plan = bp.build_plan_bitmap(torch.from_numpy(ptr.astype(np.int32)),
                                torch.from_numpy(cols.astype(np.int32)), n, n)
    words = bp.pack_bitmap(torch.ones(n))
    with pytest.raises(TypeError):
        bp.spmv_bitmap_pull(dataclasses.replace(
            plan, mask=torch.zeros(n, dtype=torch.float64)), words)
    with pytest.raises(ValueError):
        bp.spmv_bitmap_pull(dataclasses.replace(
            plan, mask=torch.zeros(n + 1)), words)


def _recording(monkeypatch):
    """Record the plan of every bitmap pull that mxv_dual launches."""
    plans = []
    inner = dispatch.spmv_bitmap_pull

    def record(plan, words):
        plans.append(plan)
        return inner(plan, words)

    monkeypatch.setattr(dispatch, "spmv_bitmap_pull", record)
    return plans


def _images(f):
    return (f.dense, f.sind, f.sval, f.snvals, f.ratio, f.use_sparse)


@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHPULL"])
def test_mxv_dual_masked_plan_equals_count_and_masked_fill(monkeypatch,
                                                           mode):
    """BFS's expand step over rmat10's levels from its hub: through the
    masked plan (a float32 mask) and through K1's count and masked_fill (the
    same mask as float64, which keeps that route), the same DualFrontier,
    image for image, and the same direction."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(10, 16, seed=42, device="cpu")
    plan = bp.plan_for_bitmap(A, transpose=True)
    n = A.nrows
    hub = int(np.argmax(np.diff(A.host_csr()[0])))
    plans = _recording(monkeypatch)
    kw = dict(transpose=True, mask_scmp=True, structure_only=True,
              mode=getattr(tgb.Direction, mode), pull_plan=plan)
    v = torch.zeros(n, dtype=torch.float32)
    f = _initial_frontier(n, hub, A.device)
    it, pulls = 1, 0
    while int(f.snvals) > 0:
        v.masked_fill_(f.dense != 0, float(it))
        del plans[:]
        got, push = dispatch.mxv_dual(A, f, tgb.LogicalOrAndSemiring, 0.0,
                                      mask_dense=v, **kw)
        assert [p.mask is v and p.mask_scmp for p in plans] == [True] * (
            not push)
        del plans[:]
        want, push2 = dispatch.mxv_dual(A, f, tgb.LogicalOrAndSemiring, 0.0,
                                        mask_dense=v.double(), **kw)
        assert [p.mask is None for p in plans] == [True] * (not push)
        assert push == push2
        pulls += not push
        for a, b in zip(_images(got), _images(want)):
            assert (a is None and b is None) or torch.equal(
                torch.as_tensor(a), torch.as_tensor(b))
        f, it = got, it + 1
    assert pulls >= 2


@pytest.mark.parametrize("graph", ["rmat10", "rmat12"])
@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHPULL"])
def test_bfs_over_the_masked_pull_matches_jax(monkeypatch, graph, mode):
    """BFS levels from vertex 0 and the hub equal the JAX package's on the
    RMAT graphs tests/test_torch_bfs.py uses, every pull through the
    masked plan."""
    import graphblast_tpu as jgb
    from graphblast_tpu.algorithms import bfs as jax_bfs
    from graphblast_tpu.io.rmat import rmat_matrix as jrmat
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    scale, ef, seed = (10, 16, 42) if graph == "rmat10" else (12, 8, 3)
    J = jrmat(scale, ef, seed=seed)
    A = rmat_matrix(scale, ef, seed=seed, device="cpu")
    desc = tgb.BFS_TUNED.replace(mxv_mode=getattr(tgb.Direction, mode))
    jdesc = jgb.BFS_TUNED.replace(mxv_mode=getattr(jgb.Direction, mode))
    plans = _recording(monkeypatch)
    hub = int(np.argmax(np.diff(A.host_csr()[0])))
    for s in (0, hub):
        got = tgb.algorithms.bfs(A, s, desc).to_numpy()
        want = np.asarray(jax_bfs(J, s, desc=jdesc).to_numpy())
        np.testing.assert_array_equal(got, want)
    assert plans and all(p.mask is not None and p.mask_scmp for p in plans)
