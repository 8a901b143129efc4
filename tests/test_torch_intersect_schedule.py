"""The intersection schedule of T1 and T2
(graphblast_tpu_torch/ops/kernels/intersect_schedule.py) on the CPU: its
work units and routes against the module's stated cost formula, recomputed
here in NumPy, and its cache in ops/spgemm.py. No JAX: the schedule has no
counterpart in the JAX package, whose results the spgemm and tc tests hold
the port to on every route (tests/test_torch_intersect_replay.py replays
both routes)."""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops import spgemm as sp
from graphblast_tpu_torch.ops.kernels import intersect_schedule as isch
from graphblast_tpu_torch.ops.kernels import masked_intersect as mx

CSRC = os.path.join(os.path.dirname(__file__), "..", "graphblast_tpu_torch",
                    "csrc", "masked_intersect.cu")


def _lists(rng, n, n_ids, hubs):
    """CSR pointers and ids of n sorted lists without duplicates, some of
    them `hubs` lists of up to n_ids ids."""
    lens = rng.integers(0, max(2, n_ids // 4), n)
    lens[rng.integers(0, n, hubs)] = rng.integers(n_ids // 2, n_ids + 1,
                                                  hubs)
    ind = [np.sort(rng.choice(n_ids, int(k), replace=False)) for k in lens]
    ptr = np.zeros(n + 1, np.int64)
    ptr[1:] = np.cumsum(lens)
    return (torch.tensor(ptr, dtype=torch.int32),
            torch.tensor(np.concatenate(ind + [np.zeros(0, np.int64)]),
                         dtype=torch.int32))


def _random_operands(seed):
    """(mi, mj, a_ptr, b_ptr, n_ids) from a seed: mask rows in order, with
    hub rows of many edges, over random sorted lists."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    n_ids = int(rng.integers(1, 300))
    a_ptr, _ = _lists(rng, n_rows, n_ids, int(rng.integers(0, 3)))
    b_ptr, _ = _lists(rng, n_cols, n_ids, int(rng.integers(0, 3)))
    m = int(rng.integers(0, 4 * n_rows * 2))
    rows = rng.integers(0, n_rows, m)
    rows[: m // 2] = rng.integers(0, max(1, n_rows // 8 + 1), m // 2)
    key = np.unique(rows.astype(np.int64) * n_cols
                    + rng.integers(0, n_cols, m))
    mi = torch.tensor(key // n_cols, dtype=torch.int32)
    mj = torch.tensor(key % n_cols, dtype=torch.int32)
    return mi, mj, a_ptr, b_ptr, n_ids


def _bit_length(x):
    return np.array([int(v).bit_length() for v in x], np.int64)


def _routes_by_formula(mi, mj, a_ptr, b_ptr, n_ids, fold, budget):
    """Each edge's route by the module's formula, in NumPy: bitmap where
    BITMAP_ID·|lb| + (STAGE_ID·|la| + PIECE)/r < SEARCH_SECTOR·w·max(1,
    bit_length(l) - 3) and the bitmap fits the budget."""
    mi, mj = mi.numpy().astype(np.int64), mj.numpy().astype(np.int64)
    a_ptr, b_ptr = a_ptr.numpy(), b_ptr.numpy()
    la = (a_ptr[mi + 1] - a_ptr[mi]).astype(np.int64)
    lb = (b_ptr[mj + 1] - b_ptr[mj]).astype(np.int64)
    _, run, r = np.unique(mi, return_inverse=True, return_counts=True)
    r = r[run]
    search = (isch.SEARCH_SECTOR * np.minimum(la, lb)
              * np.maximum(1, _bit_length(np.maximum(la, lb)) - 3))
    # compared times r, in integers
    bitmap = (isch.BITMAP_ID * lb * r + isch.STAGE_ID * la + isch.PIECE
              < search * r)
    fits = -(-n_ids // 32) * (8 if fold else 4) <= budget
    return bitmap & fits


def _unit_edges(s):
    """[sorted edge ids of unit u] of schedule s, with each bitmap piece's
    edges checked to lie on one mask row."""
    search, bitmap = s.search_edges.tolist(), s.bitmap_edges.tolist()
    us, up, pb = s.unit_search.tolist(), s.unit_piece.tolist(), \
        s.piece_begin.tolist()
    out = []
    for u in range(s.units):
        edges = search[us[u]:us[u + 1]]
        for p in range(up[u], up[u + 1]):
            edges += bitmap[pb[p]:pb[p + 1]]
        out.append(sorted(edges))
    return out


@settings(max_examples=80, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       unit_cost=st.sampled_from([1, 64, 600, 5_000, isch.UNIT_COST]),
       fold=st.booleans(), budget=st.sampled_from([0, 64, isch.SMEM_BUDGET]))
def test_schedule_units_and_routes(seed, unit_cost, fold, budget):
    """Every mask edge lies in exactly one unit; units follow mask-row
    order, each a run of consecutive edges, cut inside a mask row only
    where that row's cost alone passes the target (the least of unit_cost
    and the total over MIN_UNITS); each bitmap piece is one mask row's;
    each edge's route is the cheaper by the stated formula."""
    mi, mj, a_ptr, b_ptr, n_ids = _random_operands(seed)
    s = isch.build_intersect_schedule(mi, mj, a_ptr, b_ptr, n_ids, fold,
                                      budget, unit_cost)
    m = mi.shape[0]
    want = _routes_by_formula(mi, mj, a_ptr, b_ptr, n_ids, fold, budget)
    np.testing.assert_array_equal(s.bitmap.numpy(), want)
    assert s.routes == {"bitmap": int(want.sum()),
                        "search": m - int(want.sum())}
    assert s.words == (-(-n_ids // 32) if want.any() else 0)
    units = _unit_edges(s)
    flat = [e for edges in units for e in edges]
    assert flat == list(range(m))          # each edge once, units in order
    assert all(edges for edges in units)   # no empty unit
    search, bitmap_r, r, _ = isch.edge_costs(mi, mj, a_ptr, b_ptr)
    cost = isch.EDGE + np.where(want, -(-bitmap_r.numpy() // r.numpy()),
                                search.numpy())
    assert s.target == (min(unit_cost, -(-int(cost.sum()) // isch.MIN_UNITS))
                        if m else unit_cost)
    rows = mi.tolist()
    for u in range(1, len(units)):
        e = units[u][0]
        if e and rows[e] == rows[e - 1]:   # a cut inside a mask row
            assert cost[np.array(rows) == rows[e]].sum() > s.target
    pb, be = s.piece_begin.tolist(), s.bitmap_edges.tolist()
    for p in range(s.pieces):
        assert len({rows[e] for e in be[pb[p]:pb[p + 1]]}) == 1


def test_schedule_of_no_edges():
    empty = torch.zeros(0, dtype=torch.int32)
    ptr = torch.zeros(3, dtype=torch.int32)
    s = isch.build_intersect_schedule(empty, empty, ptr, ptr, 2, True)
    assert (s.units, s.pieces, s.routes) == (
        0, 0, {"bitmap": 0, "search": 0})


def test_kernel_budget_matches_the_schedule():
    """SMEM_BUDGET mirrors kSmemBudget of the kernel source."""
    with open(CSRC) as f:
        src = f.read()
    got = re.search(r"kSmemBudget = (\d+) \* (\d+);", src)
    assert int(got.group(1)) * int(got.group(2)) == isch.SMEM_BUDGET


def _fuzz(seed):
    rng = np.random.default_rng(seed)
    n = 60

    def mat():
        rows = np.r_[rng.integers(0, n, 200), np.full(40, 3)]
        cols = rng.integers(0, n, 240)
        key = np.unique(rows * n + cols)
        return tgb.Matrix.from_coo(key // n, key % n,
                                   np.ones(len(key), np.float32), n, n,
                                   device="cpu")
    return mat(), mat(), mat()


def test_schedule_is_cached_per_operands():
    """A second spgemm_masked_count on the same operands reuses the mask's
    cached schedule; a call with another B builds another; the fold keeps
    a schedule of its own, and the trace's is cached in A's plans."""
    A, B, M = _fuzz(1)
    B2 = _fuzz(2)[1]
    want = sp.spgemm_masked_count_plain(A, B, M)
    assert sp.spgemm_masked_count(A, B, M) == want
    cache = M._plans["intersect/mask"]
    assert len(cache) == 1
    first = cache[0][2]
    assert sp.spgemm_masked_count(A, B, M) == want
    assert len(cache) == 1 and cache[0][2] is first
    assert sp.spgemm_masked_count(A, B2, M) == \
        sp.spgemm_masked_count_plain(A, B2, M)
    assert len(cache) == 2 and cache[1][2] is not first
    assert cache[1][1] is B2.col_ptr
    sp.spgemm_masked(A, B, M, tgb.PlusMultipliesSemiring)
    assert len(cache) == 3 and cache[2][2].fold and not first.fold
    assert sp.schedule_for(M, sp._operands(A, B, M, False), A.ncols,
                           True) is cache[2][2]
    sp.intersect_rows_reduce(A, B, tgb.PlusMultipliesSemiring)
    sp.intersect_rows_reduce(A, B, tgb.PlusMultipliesSemiring)
    assert len(A._plans["intersect/trace"]) == 1
    for _ in range(sp.SCHEDULES_KEPT + 2):
        sp.spgemm_masked_count(A, _fuzz(3)[1], M)
    assert len(cache) == sp.SCHEDULES_KEPT


def test_tc_builds_its_schedule_once():
    L = tgb.tril(_fuzz(4)[0])
    n = tgb.algorithms.tc(L)
    sched = L._plans["intersect/mask"][0][2]
    assert tgb.algorithms.tc(L) == n == tgb.algorithms.tc_cpu(L)
    assert len(L._plans["intersect/mask"]) == 1
    assert L._plans["intersect/mask"][0][2] is sched
    assert sum(sched.routes.values()) == L.nvals


def test_wrapper_refuses_a_schedule_of_other_operands():
    A, B, M = _fuzz(5)
    ops = sp._operands(A, B, M, False)
    args = sp._count_args(ops)
    count = sp.schedule_for(M, ops, A.ncols, False)
    assert mx._schedule(*args, count, False) is count
    with pytest.raises(ValueError, match="fold"):
        mx._schedule(*args, count, True)
    other = sp._operands(A, B, A, False)
    with pytest.raises(ValueError, match="other operands"):
        mx._schedule(*sp._count_args(other), count, False)
    built = mx._schedule(*args, None, True)
    assert built.fold and built.n_ids == max(int(A.col_ind.max()),
                                             int(B.csc_row_ind.max())) + 1
