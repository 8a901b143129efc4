"""The monoid pull (K4) and the bitmap pull (K1) on the row schedule, on the
CPU (graphblast_tpu_torch).

The CUDA kernels read rows through the orientation's RowSchedule, as the
value pull does (csrc/row_schedule.cuh). Here their folds are replayed in
NumPy from the schedule alone: each work item's edges folded from the
monoid's identity (min or max of the clamped float32 products for K4, the
int32 count of set bits for K1), and a long row's chunk results folded in
chunk order from the identity. min, max and integer counts do not depend
on order, so the replay must equal the plain versions exactly (tolerance
0), on every input of tests/test_torch_value_sched.py. The replay is also
held to the JAX package's Pallas kernels in interpret mode: K4's
spmv_monoid on the input tests/test_torch_monoid.py holds it to (rel 1e-5,
matmul="highest", that file's bar), K1's spmv_bilinear_bitmap exactly.
Then the plans: every plan of an orientation hands out the one schedule
cached on the Matrix, and a plan refuses a schedule of another row count
or device.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops.kernels import bitmap_pull as bp
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp
from graphblast_tpu_torch.ops.kernels import row_schedule as rs
from graphblast_tpu_torch.ops.kernels import value_pull as vp
from test_torch_value_sched import CASES, _case, _work_items

MAXF = np.float32(np.finfo(np.float32).max)
SEMIRINGS = ["MinimumPlus", "MinimumMultiplies", "MinimumSelectSecond",
             "MaximumMultiplies"]


def _sr(name, pkg=tgb):
    return getattr(pkg.semiring, f"{name}Semiring")


def _replay_fold(sched, ptr, terms, ident, fold, n_out):
    """The kernels' folds from the schedule alone: each item's edge terms
    folded from `ident`, then a long row's chunk results folded in chunk
    order from `ident`."""
    y = np.full(n_out, ident, terms.dtype)
    chunks = np.full(sched.n_chunks, ident, terms.dtype)
    for _, row, beg, end, c in _work_items(sched, ptr):
        r = fold.reduce(terms[beg:end], initial=ident)
        if c < 0:
            y[row] = r
        else:
            chunks[c] = r
    for k in range(sched.bin_rows[0]):
        total = ident
        for c in range(rs.CLUSTER * k, rs.CLUSTER * (k + 1)):
            total = fold(total, chunks[c])
        y[int(sched.perm[k])] = total
    return y


def _monoid_terms(name, cols, vals, x):
    """Each edge's product in float32, clamped to ±FLT_MAX, as K4 forms
    it (__fadd_rn / __fmul_rn, no fused multiply-add)."""
    mul = mp.SEMIRING_MAP[name][1]
    xv = x[cols]
    with np.errstate(over="ignore"):
        p = {"plus": vals + xv, "mul": vals * xv, "second": xv}[mul]
    return np.clip(p, -MAXF, MAXF).astype(np.float32)


def _monoid_replay(name, sched, ptr, cols, vals, x, n_out):
    add = mp.SEMIRING_MAP[name][0]
    ident = np.float32(float(_sr(name).identity(torch.float32)))
    return _replay_fold(sched, ptr, _monoid_terms(name, cols, vals, x),
                        ident, np.minimum if add == "min" else np.maximum,
                        n_out)


def _sssp_x(x, seed=5):
    # SSSP's frontier: 40% unreached (FLT_MAX), which saturates sums
    rng = np.random.default_rng(seed)
    return np.where(rng.random(x.shape[0]) < 0.4, MAXF, x).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_monoid_schedule_folds_match_plain(name, semiring):
    """K4's folds replayed from the schedule equal spmv_monoid_plain
    exactly; empty rows keep the identity."""
    n_out, n_in, ptr, cols, vals, x = _case(name)
    x = _sssp_x(x)
    t_ptr = torch.from_numpy(ptr.astype(np.int32))
    sched = rs.build_schedule(t_ptr)
    plan = mp.build_plan_monoid(t_ptr, torch.from_numpy(cols.astype(
        np.int32)), torch.from_numpy(vals), n_out, n_in, sched)
    assert plan.sched is sched
    got = _monoid_replay(semiring, sched, ptr, cols, vals, x, n_out)
    want = mp.spmv_monoid_plain(plan, torch.from_numpy(x),
                                _sr(semiring)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ident = np.float32(float(_sr(semiring).identity(torch.float32)))
    assert (got[np.diff(ptr) == 0] == ident).all()


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("density", [0.2, 1.0])
def test_bitmap_schedule_counts_match_plain_and_pallas(name, density):
    """K1's int32 counts replayed from the schedule equal
    spmv_bitmap_pull_plain and the JAX spmv_bilinear_bitmap (Pallas, in
    interpret mode) exactly; empty rows count 0."""
    from graphblast_tpu.ops.pallas.bilinear import (build_plan_bitmap,
                                                    spmv_bilinear_bitmap)
    from graphblast_tpu.ops.pallas.orpull import pack_bitmap

    n_out, n_in, ptr, cols, _, _ = _case(name)
    f = (np.random.default_rng(9).random(n_in) < density).astype(np.float32)
    t_ptr = torch.from_numpy(ptr.astype(np.int32))
    sched = rs.build_schedule(t_ptr)
    plan = bp.build_plan_bitmap(t_ptr, torch.from_numpy(cols.astype(
        np.int32)), n_out, n_in, sched)
    assert plan.sched is sched
    bits = (f[cols] != 0).astype(np.int32)
    got = _replay_fold(sched, ptr, bits, np.int32(0), np.add, n_out)
    want = bp.spmv_bitmap_pull_plain(
        plan, bp.pack_bitmap(torch.from_numpy(f))).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[np.diff(ptr) == 0] == 0).all()
    if n_out:   # the Pallas plan needs an output row
        jax_y = np.asarray(spmv_bilinear_bitmap(
            build_plan_bitmap(ptr, cols, n_out, n_in),
            pack_bitmap(jnp.asarray(f)), interpret=True, sweep="aligned"))
        np.testing.assert_array_equal(got, jax_y)


def _pallas_case():
    """The input of tests/test_torch_monoid.py's Pallas comparison (that of
    tests/test_pallas.py::test_monoid_pull_kernel_goldens' smoke size): n =
    300, m = 2500 (deduplicated), seed 0, weights in [0.5, 3.5), x with 40%
    FLT_MAX entries and the rest in [0, 5)."""
    rng = np.random.default_rng(0)
    n_out, n_in, m = 300, 300, 2500
    rows = rng.integers(0, n_out, m)
    cols = rng.integers(0, n_in, m)
    _, keep = np.unique(rows.astype(np.int64) * n_in + cols,
                        return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = (rng.random(len(rows)) * 3 + 0.5).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    x = np.where(rng.random(n_in) < 0.4, MAXF,
                 (rng.random(n_in) * 5).astype(np.float32)).astype(np.float32)
    return ptr, cols, vals, x, n_out, n_in


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_monoid_schedule_folds_match_pallas(semiring):
    """K4's folds replayed from the schedule vs the JAX spmv_monoid (Pallas,
    interpret mode, matmul="highest") at rel 1e-5, the bar of
    tests/test_torch_monoid.py, and exactly the plain version."""
    from graphblast_tpu.ops.pallas.monopull import (build_plan_monoid,
                                                    spmv_monoid)

    ptr, cols, vals, x, n_out, n_in = _pallas_case()
    sched = rs.build_schedule(torch.from_numpy(ptr.astype(np.int32)))
    got = _monoid_replay(semiring, sched, ptr, cols, vals, x, n_out)
    want = np.asarray(spmv_monoid(
        build_plan_monoid(ptr, cols, vals, n_out, n_in), jnp.asarray(x),
        _sr(semiring, jgb), matmul="highest"))
    rel = np.abs(got.astype(np.float64) - want) / (np.abs(want) + 1)
    assert rel.max() <= 1e-5, rel.max()
    plan = mp.build_plan_monoid(
        torch.from_numpy(ptr.astype(np.int32)),
        torch.from_numpy(cols.astype(np.int32)), torch.from_numpy(vals),
        n_out, n_in)
    np.testing.assert_array_equal(
        got, mp.spmv_monoid_plain(plan, torch.from_numpy(x),
                                  _sr(semiring)).numpy())


def _directed_matrix():
    rows, cols = np.array([0, 0, 1, 3, 3]), np.array([1, 2, 2, 0, 4])
    return tgb.Matrix.from_coo(rows, cols, np.arange(1.0, 6.0), 4, 5,
                               device="cpu")


def test_plans_share_the_orientation_schedule():
    """plan_for, plan_for_monoid and plan_for_bitmap hand out the very
    schedule object cached for their orientation (schedule_for): the CSC's
    for BFS, SSSP and PageRank, the CSR's for CC's unit plan."""
    from graphblast_tpu_torch.algorithms.bfs import bfs_pull_plan
    from graphblast_tpu_torch.algorithms.pr import prepare_pr_plan

    A = _directed_matrix()
    csc = rs.schedule_for(A, transpose=True)
    assert csc is A._plans["csc/schedule"]
    assert rs.schedule_for(A, transpose=True) is csc
    assert vp.plan_for(A, transpose=True).sched is csc
    assert mp.plan_for_monoid(A, transpose=True).sched is csc
    assert bp.plan_for_bitmap(A, transpose=True).sched is csc
    assert bfs_pull_plan(A).sched is csc
    assert prepare_pr_plan(A).sched is csc       # a host_val plan
    assert csc.perm.shape[0] == 5                # the CSC's 5 columns
    B = _directed_matrix()                       # plans first, then the cache
    csr_plans = [mp.plan_for_monoid(B, ones=True), vp.plan_for(B),
                 bp.plan_for_bitmap(B), mp.plan_for_monoid(B)]
    csr = B._plans["csr/schedule"]
    assert all(p.sched is csr for p in csr_plans)
    assert csr.perm.shape[0] == 4 and csr is rs.schedule_for(B)
    assert "csc/schedule" not in B._plans
    C = tgb.Matrix.from_coo(np.array([0]), np.array([1]), np.ones(1), 2, 2,
                            fmt=tgb.types.SparseFormat.CSRONLY, device="cpu")
    assert rs.schedule_for(C, transpose=True) is None


@pytest.mark.parametrize("kind", ["monoid", "bitmap"])
def test_monoid_and_bitmap_plans_check_their_schedule(kind):
    """A schedule for another row count, or on another device, is refused;
    a CPU plan gets none unless one is handed to it (a launch on the card
    needs one)."""
    def build(sched=None):
        ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
        ind = torch.tensor([0, 1, 1], dtype=torch.int32)
        if kind == "monoid":
            return mp.build_plan_monoid(ptr, ind, None, 2, 2, sched)
        return bp.build_plan_bitmap(ptr, ind, 2, 2, sched)

    assert build().sched is None
    with pytest.raises(ValueError):
        build(rs.build_schedule(torch.tensor([0, 3], dtype=torch.int32)))
    own = rs.build_schedule(torch.tensor([0, 2, 3], dtype=torch.int32))
    assert build(own).sched is own
    with pytest.raises(ValueError):
        build(dataclasses.replace(own, perm=own.perm.to("meta")))
