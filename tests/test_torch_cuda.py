"""Tests of graphblast_tpu_torch that need an NVIDIA card (marker `cuda`).

They skip where torch.cuda.is_available() is False. On a machine with a
card:  python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops.kernels import bitmap_pull as bp
from graphblast_tpu_torch.ops.kernels import bitmap_push as bpush
from graphblast_tpu_torch.ops import spgemm as sg
from graphblast_tpu_torch.ops.kernels import gather as kg
from graphblast_tpu_torch.ops.kernels import intersect_schedule as isch
from graphblast_tpu_torch.ops.kernels import masked_intersect as mx
from graphblast_tpu_torch.ops.kernels import minmax_pull as mm
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp
from graphblast_tpu_torch.ops.kernels import orpull as ko
from graphblast_tpu_torch.ops.kernels import row_schedule as rs
from graphblast_tpu_torch.ops.kernels import value_pull as vp

import test_torch_masked_monoid as monoid_cases
import test_torch_masked_pull as masked_cases
from test_torch_intersect_replay import (ORDERED_DTYPES, ROUTINGS,
                                         SEMIRING_DTYPES, _ids_bound,
                                         _long_lists_coo, _sr,
                                         fuzz_matrices, nested_coo,
                                         replay_ordered, replay_ops)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_out,n_in,m", [(500, 700, 3000), (20000, 9000, 1),
                                          (1, 33, 0), (3000, 100000, 200000)])
def test_kernel_matches_plain_on_the_card(cuda, n_out, n_in, m):
    rng = np.random.default_rng(n_out + m)
    rows = np.sort(rng.integers(0, n_out, m))
    cols = rng.integers(0, n_in, m)
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols.astype(np.int32)).to(cuda), n_out, n_in)
    f = torch.from_numpy((rng.random(n_in) < 0.3).astype(np.float32))
    words = bp.pack_bitmap(f.to(cuda))
    launches = bp.spmv_bitmap_pull.launches
    y = bp.spmv_bitmap_pull(plan, words)
    torch.cuda.synchronize()
    assert bp.spmv_bitmap_pull.launches == launches + 1
    assert torch.equal(y, bp.spmv_bitmap_pull_plain(plan, words))
    np.testing.assert_array_equal(words.cpu().numpy(),
                                  bp.pack_bitmap(f).numpy())


def test_bfs_on_the_card_matches_golden(cuda):
    """BFS from the hub at RMAT scale 12: levels equal to the golden, one
    K1 launch an iteration, over a plan that reads the CSC's schedule,
    which PageRank's and SSSP's plans share."""
    from graphblast_tpu_torch.algorithms.bfs import bfs_pull_plan
    from graphblast_tpu_torch.algorithms.pr import prepare_pr_plan
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    deg = np.diff(A.host_csr()[0])
    s = int(np.argmax(deg))
    desc = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PULLONLY)
    launches = bp.spmv_bitmap_pull.launches
    got = tgb.algorithms.bfs(A, s, desc).to_numpy()
    np.testing.assert_array_equal(got, tgb.algorithms.bfs_cpu(A, s))
    assert bp.spmv_bitmap_pull.launches - launches == int(got.max())
    sched = A._plans["csc/schedule"]
    assert bfs_pull_plan(A, desc).sched is sched
    assert prepare_pr_plan(A).sched is sched
    assert mp.plan_for_monoid(A, transpose=True).sched is sched


def _hub_rows(rng, n_out, m, hub):
    # m random edges, `hub` more on the middle row
    return np.sort(np.r_[rng.integers(0, n_out, m), np.full(hub, n_out // 2)])


def _uniform_rows(rng, n_out, m, hub):
    # K3's regime: m // n_out (8) edges on every row
    return np.repeat(np.arange(n_out), m // n_out)


@pytest.mark.parametrize("n_out,n_in,m,hub,rows_of", [
    (500, 700, 3000, 0, _hub_rows), (20000, 9000, 1, 0, _hub_rows),
    (1, 33, 0, 0, _hub_rows), (3000, 100000, 200000, 0, _hub_rows),
    (300, 5000, 9000, 6000, _hub_rows),
    (300, 5000, 9000, 3 * rs.LONG_ROW + 777, _hub_rows),
    (1, 5000, 0, 3 * rs.LONG_ROW + 1, _hub_rows),
    (50000, 70000, 400000, 0, _uniform_rows)],
    ids=["random", "one_edge", "one_row_empty", "wide", "hub",
         "hub_over_3T", "one_long_row", "uniform8"])
@pytest.mark.parametrize("unit", [False, True])
def test_value_pull_matches_plain_on_the_card(cuda, n_out, n_in, m, hub,
                                              rows_of, unit):
    """The value-pull kernel vs its plain version within 1e-5 * max|y| (the
    bar of tests/test_pallas.py; the kernel sums in float32, the plain
    version in float64), and bitwise equal to a second launch, through every
    bin of the row schedule: `hub` edges go to one row (over 3·T: a long row
    cut into chunks), or every row has 8 edges. The edge arrays carry
    padding past ptr[n_out]."""
    rng = np.random.default_rng(n_out + m + unit)
    rows = rows_of(rng, n_out, m, hub)
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    pad = np.zeros(128, np.int64)
    val = None if unit else torch.from_numpy(
        rng.standard_normal(len(rows) + 128).astype(np.float32)).to(cuda)
    plan = vp.build_plan(torch.from_numpy(ptr.astype(np.int32)).to(cuda),
                         torch.from_numpy(np.r_[cols, pad].astype(np.int32))
                         .to(cuda), val, n_out, n_in)
    x = torch.from_numpy(rng.standard_normal(n_in).astype(np.float32)).to(cuda)
    launches = vp.spmv_value_pull.launches
    y = vp.spmv_value_pull(plan, x)
    y2 = vp.spmv_value_pull(plan, x)
    torch.cuda.synchronize()
    assert vp.spmv_value_pull.launches == launches + 2
    want = vp.spmv_value_pull_plain(plan, x)
    assert y.shape == (n_out,) and y.dtype == torch.float32
    assert float((y - want).abs().max()) <= 1e-5 * max(
        float(want.abs().max()), 1e-30)
    assert torch.equal(y, y2)
    if hub > 3 * rs.LONG_ROW:   # one cluster of chunks a long row
        assert plan.sched.n_chunks == rs.CLUSTER * plan.sched.bin_rows[0]
        assert plan.sched.bin_rows[0] >= 1


def test_value_pull_refuses_what_the_kernel_does_not_take(cuda):
    plan = vp.build_plan(torch.tensor([0, 1], dtype=torch.int32, device=cuda),
                         torch.tensor([0], dtype=torch.int32, device=cuda),
                         None, 1, 4)
    with pytest.raises(ValueError):
        vp.spmv_value_pull(plan, torch.zeros(8, device=cuda)[::2])
    with pytest.raises(TypeError):
        vp.spmv_value_pull(plan, torch.zeros(4, device=cuda,
                                             dtype=torch.float64))
    with pytest.raises(ValueError):
        vp.spmv_value_pull(plan, torch.zeros(4))
    with pytest.raises(ValueError):    # a plan with no schedule
        vp.spmv_value_pull(dataclasses.replace(plan, sched=None),
                           torch.zeros(4, device=cuda))


def test_pr_on_the_card_matches_golden(cuda):
    """PageRank on the card vs the port's NumPy golden at its fixed point
    (rtol 1e-3 / atol 1e-6, as tests/test_algorithms.py), one value-pull
    launch per iteration."""
    from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    launches = vp.spmv_value_pull.launches
    got = tgb.algorithms.pr(A, eps=1e-10).to_numpy()
    launches = vp.spmv_value_pull.launches - launches
    want = tgb.algorithms.pr_cpu(A, 0.85, eps=1e-14, max_niter=300)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    _, iters, err = _pr_fused(A, prepare_pr_plan(A), alpha=0.85, eps=1e-10,
                              max_niter=tgb.DEFAULT.max_niter)
    assert launches == iters > 0 and err <= 1e-10


MONOID_SEMIRINGS = ["MinimumPlus", "MinimumMultiplies", "MinimumSelectSecond",
                    "MaximumMultiplies"]


@pytest.mark.parametrize("n_out,n_in,m,hub", [
    (300, 300, 2500, 0), (20000, 9000, 1, 0), (1, 33, 0, 0),
    (3000, 100000, 200000, 0), (300, 5000, 9000, 6000)])
@pytest.mark.parametrize("name", MONOID_SEMIRINGS)
@pytest.mark.parametrize("unit", [False, True])
def test_monoid_pull_matches_plain_on_the_card(cuda, n_out, n_in, m, hub,
                                               name, unit):
    """K4 vs its plain version, tolerance 0 (min and max pick one product,
    each product one float32 operation, on both), and bitwise equal to a
    second launch. x has 40% FLT_MAX entries, values may be negative and
    1e38 large so that products overflow and saturate; `hub` edges go to
    one row; the edge arrays carry padding past ptr[n_out]."""
    rng = np.random.default_rng(n_out + m + unit)
    rows = np.sort(np.r_[rng.integers(0, n_out, m), np.full(hub, n_out // 2)])
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    pad = np.zeros(128, np.int64)
    vals = rng.uniform(-2.0, 2.0, len(rows) + 128).astype(np.float32)
    vals[::97] = 1e38
    val = None if unit else torch.from_numpy(vals).to(cuda)
    plan = mp.build_plan_monoid(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(np.r_[cols, pad].astype(np.int32)).to(cuda), val,
        n_out, n_in)
    maxf = np.float32(np.finfo(np.float32).max)
    x = np.where(rng.random(n_in) < 0.4, maxf,
                 rng.uniform(-5.0, 5.0, n_in)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    launches = mp.spmv_monoid.launches
    y = mp.spmv_monoid(plan, x, sr)
    y2 = mp.spmv_monoid(plan, x, sr)
    torch.cuda.synchronize()
    assert mp.spmv_monoid.launches == launches + 2
    assert y.shape == (n_out,) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x, sr))
    assert torch.equal(y, y2)
    cpu = mp.build_plan_monoid(plan.ptr.cpu(), plan.ind.cpu(),
                               None if unit else plan.val.cpu(), n_out, n_in)
    assert torch.equal(y.cpu(), mp.spmv_monoid(cpu, x.cpu(), sr))


def test_sssp_and_cc_on_the_card_match_golden(cuda):
    """SSSP from the hub and CC at RMAT scale 12 on the card equal the
    port's goldens, with one K4 launch per iteration and no other kernel."""
    from graphblast_tpu_torch.algorithms.cc import _cc_fused
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    s = int(np.argmax(np.diff(A.host_csr()[0])))
    desc = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PULLONLY)
    others = bp.spmv_bitmap_pull.launches + vp.spmv_value_pull.launches
    launches = mp.spmv_monoid.launches
    dist = tgb.algorithms.sssp(A, s, desc).to_numpy()
    k_sssp = mp.spmv_monoid.launches - launches
    labels = tgb.algorithms.cc(A).to_numpy()
    k_cc = mp.spmv_monoid.launches - launches - k_sssp
    assert bp.spmv_bitmap_pull.launches + vp.spmv_value_pull.launches == others
    np.testing.assert_array_equal(dist, tgb.algorithms.sssp_cpu(A, s))
    np.testing.assert_array_equal(labels, tgb.algorithms.cc_cpu(A))
    assert tgb.algorithms.verify_cc(A, labels)
    _, it = _sssp_fused(A, s, mp.plan_for_monoid(A, transpose=True),
                        switchpoint=0.01, mode=tgb.Direction.PULLONLY,
                        max_niter=1000)
    _, it_cc = _cc_fused(A, mp.plan_for_monoid(A, ones=True), max_niter=1000)
    assert k_sssp == it > 0 and k_cc == it_cc > 0
    # the plans read the orientations' shared schedules
    assert mp.plan_for_monoid(A, transpose=True).sched is A._plans[
        "csc/schedule"]
    assert mp.plan_for_monoid(A, ones=True).sched is A._plans["csr/schedule"]
    assert vp.plan_for(A).sched is A._plans["csr/schedule"]


def _every_length_rows(rng, n_out, m, hub):
    # one row of each length 0 .. 40, then rows of T and T + 1 edges
    T = rs.LONG_ROW
    return np.repeat(np.arange(43), list(range(41)) + [T, T + 1])


LONG_ROW_CASES = [
    (300, 5000, 9000, 3 * rs.LONG_ROW + 777, _hub_rows),
    (1, 5000, 0, 3 * rs.LONG_ROW + 1, _hub_rows),
    (50000, 70000, 400000, 0, _uniform_rows),
    (43, 900, 0, 0, _every_length_rows)]
LONG_ROW_IDS = ["hub_over_3T", "one_long_row", "uniform8", "every_length"]


def _long_row_csr(cuda, n_out, n_in, m, hub, rows_of, seed):
    """ptr and ind (with 128 padding entries) on the card, and the host
    row lengths."""
    rng = np.random.default_rng(seed)
    rows = rows_of(rng, n_out, m, hub)
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    pad = np.zeros(128, np.int64)
    return (torch.from_numpy(ptr.astype(np.int32)).to(cuda),
            torch.from_numpy(np.r_[cols, pad].astype(np.int32)).to(cuda),
            np.diff(ptr), rng)


@pytest.mark.parametrize("n_out,n_in,m,hub,rows_of", LONG_ROW_CASES,
                         ids=LONG_ROW_IDS)
@pytest.mark.parametrize("name", MONOID_SEMIRINGS)
@pytest.mark.parametrize("unit", [False, True])
def test_monoid_pull_on_long_rows_matches_plain_on_the_card(
        cuda, n_out, n_in, m, hub, rows_of, name, unit):
    """K4 through every bin of the row schedule, long rows as clusters of
    chunks: torch.equal to its plain version and to a second launch, empty
    rows at the identity. x has 40% FLT_MAX entries."""
    ptr, ind, length, rng = _long_row_csr(cuda, n_out, n_in, m, hub,
                                          rows_of, n_out + m + unit)
    val = None if unit else torch.from_numpy(rng.uniform(
        -2.0, 2.0, ind.shape[0]).astype(np.float32)).to(cuda)
    plan = mp.build_plan_monoid(ptr, ind, val, n_out, n_in)
    assert plan.sched.bin_rows[0] == int((length > rs.LONG_ROW).sum())
    maxf = np.float32(np.finfo(np.float32).max)
    x = torch.from_numpy(np.where(
        rng.random(n_in) < 0.4, maxf,
        rng.uniform(-5.0, 5.0, n_in)).astype(np.float32)).to(cuda)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    launches = mp.spmv_monoid.launches
    y = mp.spmv_monoid(plan, x, sr)
    y2 = mp.spmv_monoid(plan, x, sr)
    torch.cuda.synchronize()
    assert mp.spmv_monoid.launches == launches + 2
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x, sr))
    assert torch.equal(y, y2)
    empty = torch.from_numpy(length == 0).to(cuda)
    assert bool((y[empty] == float(sr.identity(torch.float32))).all())


@pytest.mark.parametrize("n_out,n_in,m,hub,rows_of", LONG_ROW_CASES,
                         ids=LONG_ROW_IDS)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_pull_on_long_rows_matches_plain_on_the_card(
        cuda, n_out, n_in, m, hub, rows_of, density):
    """K1 through every bin of the row schedule, long rows as clusters of
    chunks: torch.equal to its plain version and to a second launch, empty
    rows 0."""
    ptr, ind, length, rng = _long_row_csr(cuda, n_out, n_in, m, hub,
                                          rows_of, n_out + m)
    plan = bp.build_plan_bitmap(ptr, ind, n_out, n_in)
    assert plan.sched.bin_rows[0] == int((length > rs.LONG_ROW).sum())
    f = torch.from_numpy((rng.random(n_in) < density).astype(np.float32))
    words = bp.pack_bitmap(f.to(cuda))
    launches = bp.spmv_bitmap_pull.launches
    y = bp.spmv_bitmap_pull(plan, words)
    y2 = bp.spmv_bitmap_pull(plan, words)
    torch.cuda.synchronize()
    assert bp.spmv_bitmap_pull.launches == launches + 2
    assert torch.equal(y, bp.spmv_bitmap_pull_plain(plan, words))
    assert torch.equal(y, y2)
    assert bool((y[torch.from_numpy(length == 0).to(cuda)] == 0).all())
    if density == 1.0:
        assert torch.equal(y.cpu(), torch.from_numpy(length.astype(np.int32)))


def _masked_launch(plan, words, mask, scmp):
    """K1's masked entry over `plan`, checked to count one launch and one
    masked launch."""
    launches = bp.spmv_bitmap_pull.launches
    masked = bp.spmv_bitmap_pull.masked_launches
    y = bp.spmv_bitmap_pull(dataclasses.replace(plan, mask=mask,
                                                mask_scmp=scmp), words)
    torch.cuda.synchronize()
    assert bp.spmv_bitmap_pull.launches == launches + 1
    assert bp.spmv_bitmap_pull.masked_launches == masked + 1
    return y


@pytest.mark.parametrize("csr", list(masked_cases.CSRS))
@pytest.mark.parametrize("frontier", ["hub", "level", "random20"])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("scmp", [False, True])
def test_masked_bitmap_pull_matches_plain_on_the_card(cuda, csr, frontier,
                                                      density, scmp):
    """K1's masked entry over every bin of the row schedule (a row past
    LONG_ROW included): torch.equal to its plain version, to (K1's count >
    0) & the mask's pass, and to a second launch; an unmasked launch keeps
    K1's count and adds no masked launch."""
    n, ptr, cols = masked_cases._csr(csr)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols.astype(np.int32)).to(cuda), n, n)
    f = masked_cases._frontier(frontier, n, ptr, cols)
    words = bp.pack_bitmap(torch.from_numpy(f).to(cuda))
    mask = torch.from_numpy(masked_cases._mask(density, n)).to(cuda)
    y = _masked_launch(plan, words, mask, scmp)
    masked = bp.spmv_bitmap_pull.masked_launches
    cnt = bp.spmv_bitmap_pull(plan, words)
    torch.cuda.synchronize()
    assert bp.spmv_bitmap_pull.masked_launches == masked
    assert torch.equal(cnt, bp.spmv_bitmap_pull_plain(plan, words))
    plain = bp.spmv_bitmap_pull_plain(
        dataclasses.replace(plan, mask=mask, mask_scmp=scmp), words)
    assert y.dtype == torch.int32 and torch.equal(y, plain)
    assert torch.equal(y, ((cnt > 0) & masked_cases.mask_pass(mask, scmp))
                       .to(torch.int32))
    assert torch.equal(y, _masked_launch(plan, words, mask, scmp))


@pytest.mark.parametrize("n", [(1 << 22) + 999, (1 << 17) + 5])
@pytest.mark.parametrize("density", [0.0, 0.5, 0.97])
def test_masked_bitmap_pull_at_full_warps_on_the_card(cuda, n, density):
    """CSRs of 2^22 + 999 and 2^17 + 5 rows, which give a warp 32 and 4
    rows of each bin but the short ones' minimum (row_schedule.cuh
    open_warp_rows), with short rows of each bin and medium ones: the
    masked entry equal to (K1's count > 0) & the mask's pass."""
    rng = np.random.default_rng(31)
    lengths = np.where(rng.random(n) < 0.02, rng.integers(33, 300, n),
                       rng.integers(0, 33, n))
    ptr = np.r_[0, np.cumsum(lengths)]
    cols = rng.integers(0, n, int(ptr[-1]), dtype=np.int32)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols).to(cuda), n, n)
    assert all(r > 0 for r in plan.sched.bin_rows[1:])
    f = torch.rand(n, device=cuda) < 0.03
    words = bp.pack_bitmap(f.float())
    mask = torch.where(torch.rand(n, device=cuda) < density, 2.0, 0.0)
    y = _masked_launch(plan, words, mask, True)
    cnt = bp.spmv_bitmap_pull(plan, words)
    assert torch.equal(y, ((cnt > 0) & (mask == 0)).to(torch.int32))
    assert torch.equal(y, _masked_launch(plan, words, mask, True))

def _rows_with_one_hit(rng, lengths_and_hits, n, hit):
    """A CSR of rows of the given lengths whose ids avoid vertex `hit`,
    but for one at the given position of each row (None: nowhere)."""
    rows = []
    for length, pos in lengths_and_hits:
        ids = rng.integers(0, n - 1, length)
        ids[ids >= hit] += 1
        if pos is not None:
            ids[pos] = hit
        rows.append(ids)
    ptr = np.r_[0, np.cumsum([len(r) for r in rows])]
    return ptr, np.concatenate(rows)


T = rs.LONG_ROW
# (row length, position of its one frontier id): the medium rows' 32- and
# 128-edge steps on both sides, a long row's chunks (3T + 1 edges, chunks
# of 3,073) at their first and last edges, the 8-id sub-steps of rows of
# 9 to 32 edges on both sides, and rows with no hit
HIT_ROWS = [(33, 0), (33, 32), (100, 31), (128, 127), (129, 128),
            (257, 200), (5000, 4999), (T, T - 1), (3 * T + 1, 0),
            (3 * T + 1, 3 * T), (3 * T + 1, 7 * ((3 * T + 8) // 8)),
            (3 * T + 1, 3073 - 1), (3 * T + 1, 3073), (40, None),
            (3 * T + 1, None), (2, 1), (17, 16), (0, None), (20, 7),
            (20, 8), (32, 24), (32, 31), (9, 0), (12, 8), (16, 15),
            (25, None), (13, None)]


@pytest.mark.parametrize("closed_long", [False, True])
def test_masked_bitmap_pull_stops_only_at_a_hit_on_the_card(cuda,
                                                            closed_long):
    """Rows whose one frontier id sits at a step's or a chunk's edge: an
    open row reads 1 wherever it is (a long row's only one in its last
    chunk included), a row with none 0. With closed_long every long row is
    closed: all 8 blocks of its cluster leave at the mask, and it reads
    0."""
    rng = np.random.default_rng(23)
    n = 50000
    hit = 777
    ptr, cols = _rows_with_one_hit(rng, HIT_ROWS, n, hit)
    n_out = len(HIT_ROWS)
    length = np.diff(ptr)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols.astype(np.int32)).to(cuda), n_out, n)
    assert plan.sched.bin_rows[0] == int((length > T).sum()) == 6
    f = torch.zeros(n, device=cuda)
    f[hit] = 1
    closed = (length > T) if closed_long else np.zeros(n_out, bool)
    mask = torch.from_numpy(closed.astype(np.float32)).to(cuda)
    y = _masked_launch(plan, bp.pack_bitmap(f), mask, True).cpu().numpy()
    want = np.array([pos is not None for _, pos in HIT_ROWS]) & ~closed
    np.testing.assert_array_equal(y, want.astype(np.int32))


def test_masked_bitmap_pull_mixes_closed_and_open_short_rows(cuda):
    """Warps of short rows (of 3, 7, 12 and 25 edges: every short bin)
    whose rows alternate closed and open, each row with a frontier id: the
    closed lanes join their warp's shuffles and read 0, the open ones 1."""
    rng = np.random.default_rng(29)
    n = 4096
    hit = 5
    lengths = np.repeat([3, 7, 12, 25], 64)
    ptr, cols = _rows_with_one_hit(
        rng, [(int(L), int(rng.integers(0, L))) for L in lengths], n, hit)
    n_out = len(lengths)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols.astype(np.int32)).to(cuda), n_out, n)
    assert plan.sched.bin_rows == (0, 0, 64, 64, 64, 64)
    f = torch.zeros(n, device=cuda)
    f[hit] = 1
    levels = np.where(np.arange(n_out) % 2 == 0, 0.0, 3.0)
    mask = torch.from_numpy(levels.astype(np.float32)).to(cuda)
    for scmp in (False, True):
        y = _masked_launch(plan, bp.pack_bitmap(f), mask, scmp).cpu()
        want = (levels == 0) if scmp else (levels != 0)
        np.testing.assert_array_equal(y.numpy(), want.astype(np.int32))


def _masked_monoid(plan, x, b):
    """K4's masked launch: y, and the launches it added to
    spmv_monoid.launches and .masked_launches."""
    launches = mp.spmv_monoid.launches
    masked = mp.spmv_monoid.masked_launches
    y = mp.spmv_monoid(plan, x, tgb.MinimumPlusSemiring, bound=b)
    torch.cuda.synchronize()
    return y, (mp.spmv_monoid.launches - launches,
               mp.spmv_monoid.masked_launches - masked)


@pytest.mark.parametrize("csr", list(monoid_cases.CSRS))
@pytest.mark.parametrize("weights", list(monoid_cases.WEIGHTS))
@pytest.mark.parametrize("front", monoid_cases.FRONTIERS)
def test_masked_monoid_pull_matches_plain_on_the_card(cuda, csr, weights,
                                                      front):
    """K4's masked entry over every bin of the row schedule (a row past
    LONG_ROW included): torch.equal to its plain version and to a second
    launch, equal to the unmasked K4 after SSSP's filter and at every open
    row, one launch counted in both counters; an unmasked launch counts in
    `.launches` alone."""
    n, ptr, cols, vals = monoid_cases.case(csr, weights)
    plan = monoid_cases.build(n, ptr, cols, vals, cuda)
    x = torch.from_numpy(monoid_cases.frontier(front, n, cols)).to(cuda)
    b = torch.from_numpy(monoid_cases.bound(n)).to(cuda)
    y, counted = _masked_monoid(plan, x, b)
    assert counted == (1, 1)
    masked = mp.spmv_monoid.masked_launches
    y_plain = mp.spmv_monoid(plan, x, tgb.MinimumPlusSemiring)
    torch.cuda.synchronize()
    assert mp.spmv_monoid.masked_launches == masked
    monoid_cases.check_masked(plan, x, b, y, y_plain)
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x,
                                               tgb.MinimumPlusSemiring, b))
    assert torch.equal(y, _masked_monoid(plan, x, b)[0])


@pytest.mark.parametrize("closed_long", [False, True])
def test_masked_monoid_pull_on_long_rows_on_the_card(cuda, closed_long):
    """Long rows of 3T + 777 and 3T + 1 edges (clusters of 8 blocks)
    beside short and medium ones, whole frontier: with closed_long every
    long row's bound lies under t, so its cluster leaves at the bound and
    reads FLT_MAX; else the long rows are open and equal the unmasked
    K4."""
    ptr, ind, length, rng = _long_row_csr(cuda, 300, 5000, 9000,
                                          3 * rs.LONG_ROW + 777, _hub_rows,
                                          41)
    n_in = 5000
    val = torch.from_numpy(rng.integers(1, 256, ind.shape[0]).astype(
        np.float32)).to(cuda)
    plan = mp.build_plan_monoid(ptr, ind, val, 300, n_in)
    assert plan.sched.bin_rows[0] > 0
    x = torch.from_numpy(rng.integers(300, 600, n_in).astype(
        np.float32)).to(cuda)
    long_rows = torch.from_numpy(length > rs.LONG_ROW).to(cuda)
    b = torch.where(long_rows, 0.0 if closed_long else monoid_cases.MAXF,
                    torch.from_numpy(monoid_cases.bound(300)).to(cuda))
    y, counted = _masked_monoid(plan, x, b)
    assert counted == (1, 1)
    y_plain = mp.spmv_monoid(plan, x, tgb.MinimumPlusSemiring)
    monoid_cases.check_masked(plan, x, b, y, y_plain)
    if closed_long:
        assert bool((y[long_rows] == monoid_cases.MAXF).all())
    else:
        assert torch.equal(y[long_rows], y_plain[long_rows])
        assert bool((y[long_rows] < monoid_cases.MAXF).all())


@pytest.mark.parametrize("b_kind", ["closed", "t_inf"])
def test_masked_monoid_pull_edge_cases_on_the_card(cuda, b_kind):
    """Every row closed (a bound at t everywhere), and t overflowing to
    +inf (weights and distances of 3e38): FLT_MAX everywhere, as the
    plain version and the filtered unmasked K4 give."""
    n, ptr, cols, vals = monoid_cases.case("every_bin", "int")
    x = monoid_cases.frontier("whole", n, cols)
    if b_kind == "t_inf":
        vals = np.full(len(vals), 3e38, np.float32)
        x = np.full(n, 3e38, np.float32)
    plan = monoid_cases.build(n, ptr, cols, vals, cuda)
    x = torch.from_numpy(x).to(cuda)
    t = mp.pull_threshold(plan, x)
    b = (t.expand(n).contiguous() if b_kind == "closed"
         else torch.full((n,), monoid_cases.MAXF, device=cuda))
    if b_kind == "t_inf":
        assert float(t) == float("inf")
    y, _ = _masked_monoid(plan, x, b)
    assert bool((y == monoid_cases.MAXF).all())
    monoid_cases.check_masked(plan, x, b, y, mp.spmv_monoid(
        plan, x, tgb.MinimumPlusSemiring))
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x,
                                               tgb.MinimumPlusSemiring, b))


@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHPULL"])
def test_sssp_takes_the_masked_pull_on_the_card(cuda, monkeypatch, mode):
    """SSSP at RMAT scale 12 with integer weights in [1, 255] from the hub
    and another vertex: every K4 launch masked, the distances equal to the
    port's golden and to a run with the masked entry turned off (whose
    launches count in .launches alone); CC's K4 launches are never
    masked."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    U = rmat_matrix(12, 16, seed=42, device="cpu")
    ptr, cols, _ = U.host_csr()
    n = U.nrows
    rows = np.repeat(np.arange(n), np.diff(ptr))
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    w = ((lo * 7919 + hi * 104729) % 255 + 1).astype(np.float32)
    A = tgb.Matrix.from_coo(rows, cols, w, n, n, device=cuda)
    H = tgb.Matrix.from_coo(rows, cols, w, n, n, device="cpu")
    desc = tgb.DEFAULT.replace(mxv_mode=getattr(tgb.Direction, mode))
    deg = np.diff(ptr)
    for s in (int(np.argmax(deg)), int(np.flatnonzero(deg)[7])):
        launches = mp.spmv_monoid.launches
        masked = mp.spmv_monoid.masked_launches
        got = tgb.algorithms.sssp(A, s, desc).to_numpy()
        pulls = mp.spmv_monoid.launches - launches
        assert mp.spmv_monoid.masked_launches - masked == pulls > 0
        np.testing.assert_array_equal(got, tgb.algorithms.sssp_cpu(H, s))
        with monkeypatch.context() as m:
            m.setattr(mp, "takes_bound", lambda *a: False)
            masked = mp.spmv_monoid.masked_launches
            off = tgb.algorithms.sssp(A, s, desc).to_numpy()
            assert mp.spmv_monoid.masked_launches == masked
        np.testing.assert_array_equal(got, off)
    masked = mp.spmv_monoid.masked_launches
    launches = mp.spmv_monoid.launches
    tgb.algorithms.cc(A)
    assert mp.spmv_monoid.launches > launches
    assert mp.spmv_monoid.masked_launches == masked


@pytest.mark.parametrize("build", ["monoid", "bitmap"])
def test_monoid_and_bitmap_refuse_a_plan_without_a_schedule(cuda, build):
    """A CUDA launch of a plan with no schedule raises."""
    ptr = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    ind = torch.tensor([0], dtype=torch.int32, device=cuda)
    if build == "monoid":
        plan = mp.build_plan_monoid(ptr, ind, None, 1, 4)
        with pytest.raises(ValueError):
            mp.spmv_monoid(dataclasses.replace(plan, sched=None),
                           torch.zeros(4, device=cuda),
                           tgb.MinimumPlusSemiring)
    else:
        plan = bp.build_plan_bitmap(ptr, ind, 1, 4)
        with pytest.raises(ValueError):
            bp.spmv_bitmap_pull(dataclasses.replace(plan, sched=None),
                                torch.zeros(1, dtype=torch.int32,
                                            device=cuda))


def _launches():
    return {"bitmap_pull": bp.spmv_bitmap_pull.launches,
            "value_pull": vp.spmv_value_pull.launches,
            "monoid_pull": mp.spmv_monoid.launches,
            "gather": kg.gather_1d.launches,
            "gather_sorted": kg.gather_1d.sorted_launches,
            "orpull_csum": ko.orpull_bit_csum.launches,
            "minmax_pull": mm.spmv_minmax_pull.launches}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.parametrize("n,m,sorted_idx,dtype", [
    (128, 9000, False, torch.float32), (129, 9000, False, torch.int32),
    (16384, 33000, False, torch.float32), (16384, 32768, True, torch.int32),
    (1, 5000, False, torch.float32), (40000, 12, False, torch.int32),
    (262144, 3_000_000, False, torch.float32),
    (5_000_000, 1_000_001, True, torch.int32)])
def test_gather_matches_plain_on_the_card(cuda, n, m, sorted_idx, dtype):
    """K6 vs its plain version (tolerance 0: a copy), with out-of-range
    indices on both sides clamped; bitwise equal to a second launch."""
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy((rng.standard_normal(n) * 1e6).astype(np.float32))
    x = (x if dtype == torch.float32 else x.to(torch.int32)).to(cuda)
    idx = rng.integers(0, n, m)
    idx[:4] = [0, n - 1, -7, n + 5]
    if sorted_idx:
        idx.sort()
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    before = _launches()
    y = kg.gather_1d(x, idx, sorted=sorted_idx)
    y2 = kg.gather_1d(x, idx)
    torch.cuda.synchronize()
    assert _since(before)["gather"] == 2
    assert _since(before)["gather_sorted"] == int(sorted_idx)
    assert y.dtype == dtype and y.shape == (m,)
    assert torch.equal(y, kg.gather_1d_plain(x, idx))
    assert torch.equal(y, y2)
    assert torch.equal(y.cpu(), kg.gather_1d(x.cpu(), idx.cpu()))


@pytest.mark.parametrize("m", [1, 2, 3, 5, 4097, 262_145, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_misaligned_slice_on_the_card(cuda, m, dtype):
    """K6 over idx[1:], a contiguous slice that is not 16-byte aligned,
    and m not a multiple of 4 (the scalar path and the four-query path's
    tail): equal to its plain version and to torch.index_select."""
    n = 262_144
    rng = np.random.default_rng(m)
    x = torch.from_numpy((rng.standard_normal(n) * 1e6).astype(np.float32))
    x = (x if dtype == torch.float32 else x.to(torch.int32)).to(cuda)
    base = rng.integers(0, n, m + 1)
    k = min(m, 4)
    base[1:1 + k] = [0, n - 1, -7, n + 5][:k]
    base = torch.from_numpy(base.astype(np.int32)).to(cuda)
    for idx in (base[1:], base[:m]):
        before = _launches()
        y = kg.gather_1d(x, idx)
        torch.cuda.synchronize()
        assert _since(before)["gather"] == 1
        want = kg.gather_1d_plain(x, idx)
        assert y.dtype == dtype and y.shape == (m,)
        assert torch.equal(y, want)
        assert torch.equal(y, torch.index_select(
            x, 0, idx.clamp(0, n - 1)))


@pytest.mark.parametrize("n,m", [(4096, 70000), (4095, 70000), (50, 257),
                                 (262144, 7_610_368), (33, 4096),
                                 (1000, 4097), (100000, 1)])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_orpull_matches_plain_on_the_card(cuda, n, m, density):
    """K5 vs its plain version (tolerance 0: integer counts), columns past
    the bitmap and negative ones included; bitwise equal to a second
    launch and to the CPU."""
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy((rng.random(n) < density).astype(np.float32))
    col = rng.integers(0, n, m)
    col[: min(m, 4)] = [n, -1, n - 1, 1 << 30][: min(m, 4)]
    col = torch.from_numpy(col.astype(np.int32)).to(cuda)
    words = bp.pack_bitmap(x.to(cuda))
    before = _launches()
    c = ko.orpull_bit_csum(words, col)
    c2 = ko.orpull_bit_csum(words, col)
    torch.cuda.synchronize()
    assert _since(before)["orpull_csum"] == 2
    assert c.dtype == torch.int32 and c.shape == (m,)
    assert torch.equal(c, ko.orpull_bit_csum_plain(words, col))
    assert torch.equal(c, c2)
    assert torch.equal(c.cpu(), ko.orpull_bit_csum(words.cpu(), col.cpu()))


def test_plan_less_paths_on_the_card_match_golden(cuda):
    """At RMAT scale 12 on the card: stepped BFS (one K5 and one K6 launch
    per iteration, no K1), MIS (one min/max row fold S and two K6 a round,
    one of them at the sorted row boundaries), colouring is (one S a round,
    no K6) and jp (one S and two K6), plan-less CC (one S an iteration, no
    K6); each checked against its golden or verifier and against the CPU
    with the same inputs."""
    import importlib

    from graphblast_tpu_torch.algorithms.cc import _cc_fused
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    tmis = importlib.import_module("graphblast_tpu_torch.algorithms.mis")
    tgc = importlib.import_module("graphblast_tpu_torch.algorithms.gc")
    A = rmat_matrix(12, 16, seed=42, device=cuda)
    C = rmat_matrix(12, 16, seed=42, device="cpu")
    s = int(np.argmax(np.diff(A.host_csr()[0])))
    desc = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PULLONLY)
    before = _launches()
    lv = tgb.algorithms.bfs(A, s, desc, mode="stepped").to_numpy()
    it = int(lv.max())
    assert _since(before) == dict(bitmap_pull=0, value_pull=0,
                                  monoid_pull=0, gather=it, gather_sorted=it,
                                  orpull_csum=it, minmax_pull=0)
    np.testing.assert_array_equal(lv, tgb.algorithms.bfs_cpu(A, s))

    w0 = tmis.random_weights(A.nrows, 3, "cpu")
    before = _launches()
    v, rounds = tmis._mis_fused(A, w0.to(cuda), max_niter=1000)
    assert _since(before) == dict(bitmap_pull=0, value_pull=0,
                                  monoid_pull=0, gather=2 * rounds,
                                  gather_sorted=rounds, orpull_csum=0,
                                  minmax_pull=rounds)
    assert torch.equal(v.cpu(), tmis._mis_fused(C, w0, max_niter=1000)[0])
    assert tgb.verify_mis(A, v.cpu().numpy())

    for algo, per_round in (("is", 0), ("jp", 2)):
        before = _launches()
        if algo == "is":
            col, rounds = tgc._gc_is_fused(A, w0.to(cuda), max_niter=1000)
            ref, _ = tgc._gc_is_fused(C, w0, max_niter=1000)
        else:
            col, rounds = tgc._gc_jp_fused(A, w0.to(cuda), max_colors=512,
                                           max_niter=1000)
            ref, _ = tgc._gc_jp_fused(C, w0, max_colors=512, max_niter=1000)
        assert _since(before)["gather"] == per_round * rounds
        assert _since(before)["gather_sorted"] == per_round * rounds // 2
        assert _since(before)["minmax_pull"] == rounds
        assert torch.equal(col.cpu(), ref)
        assert tgb.verify_gc(A, col.cpu().numpy())

    before = _launches()
    labels, iters = _cc_fused(A, None, max_niter=1000)
    assert _since(before) == dict(bitmap_pull=0, value_pull=0,
                                  monoid_pull=0, gather=0, gather_sorted=0,
                                  orpull_csum=0, minmax_pull=iters)
    np.testing.assert_array_equal(labels.cpu().numpy(), tgb.cc_cpu(A))
    # every S launch read the orientation's cached schedule, and MIS's the
    # one csc_int_arrays hands out
    from graphblast_tpu_torch.algorithms.common import csc_int_arrays
    assert csc_int_arrays(A)[3] is A._plans["csc/schedule"]
    assert "csr/schedule" in A._plans


@pytest.mark.parametrize("n,m", [(262144, 7_610_368), (1000, 4097),
                                 (1000, 8193), (1000, 2)])
def test_orpull_misaligned_and_short_on_the_card(cuda, n, m):
    """K5 over col_ind and over the misaligned slice col_ind[1:] (the
    scalar loads and stores), at RMAT scale 18's size and below, on and
    just past one tile of 8,192 edges: equal to its plain version."""
    rng = np.random.default_rng(n + m)
    words = bp.pack_bitmap(torch.from_numpy(
        (rng.random(n) < 0.2).astype(np.float32)).to(cuda))
    col = torch.from_numpy(rng.integers(-3, n + 40, m).astype(
        np.int32)).to(cuda)
    for c in (col, col[1:]):
        got = ko.orpull_bit_csum(words, c)
        torch.cuda.synchronize()
        assert torch.equal(got, ko.orpull_bit_csum_plain(words, c))


def test_orpull_on_two_streams_at_once(cuda):
    """K5 keeps nothing between calls: two calls in flight at once on two
    streams, on other frontiers and edge arrays, each equal to its plain
    version."""
    rng = np.random.default_rng(17)
    n, m = 262144, 7_610_368
    args = []
    for density in (0.2, 0.6):
        words = bp.pack_bitmap(torch.from_numpy(
            (rng.random(n) < density).astype(np.float32)).to(cuda))
        col = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(cuda)
        args.append((words, col))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    out = [[], []]
    for _ in range(20):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                out[k].append(ko.orpull_bit_csum(*args[k]))
    torch.cuda.synchronize()
    for k in range(2):
        want = ko.orpull_bit_csum_plain(*args[k])
        assert all(torch.equal(c, want) for c in out[k])


MINMAX_SEMIRINGS = list(mm.SEMIRING_MAP)


def _minmax_inputs(rng, n_in, n_val, kind):
    """x and val of one kind: int32 of every sign, large enough that sums
    and products wrap; float32 of every sign with ±inf in x; the same with
    NaN in x and val too."""
    if kind == "int32":
        big = np.iinfo(np.int32)
        x = rng.integers(big.min, big.max, n_in, dtype=np.int64)
        x[rng.random(n_in) < 0.5] //= 1 << 20   # small ones too, both signs
        val = rng.integers(-5, 6, n_val)
        val[::7] = big.max
        return x.astype(np.int32), val.astype(np.int32)
    x = rng.uniform(-5.0, 5.0, n_in).astype(np.float32)
    x[rng.random(n_in) < 0.1] = np.inf
    x[rng.random(n_in) < 0.1] = -np.inf
    val = rng.uniform(-2.0, 2.0, n_val).astype(np.float32)
    val[::11] = 0.0
    if kind == "float32_nan":
        x[rng.random(n_in) < 0.05] = np.nan
        val[::13] = np.nan
    return x, val


def _bits(y):
    return y.view(torch.int32) if y.dtype == torch.float32 else y


def _same(a, b):
    """Equal values, NaN where the other is NaN (torch.equal counts NaN
    unequal; zeros compare up to their sign)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("n_out,n_in,m,hub,rows_of", LONG_ROW_CASES,
                         ids=LONG_ROW_IDS)
@pytest.mark.parametrize("name", MINMAX_SEMIRINGS)
@pytest.mark.parametrize("kind", ["int32", "float32", "float32_nan"])
def test_minmax_pull_matches_plain_on_the_card(cuda, n_out, n_in, m, hub,
                                               rows_of, name, kind):
    """S through every bin of the row schedule, long rows as clusters of
    chunks: equal to its plain version on the card and on the CPU (NaN where
    it is NaN, as 0·inf or an input NaN makes it; zeros up to their sign)
    and bitwise to a second launch; empty rows at the semiring's
    identity."""
    ptr, ind, length, rng = _long_row_csr(cuda, n_out, n_in, m, hub,
                                          rows_of, n_out + m + len(name))
    x_np, val_np = _minmax_inputs(rng, n_in, ind.shape[0], kind)
    x, val = torch.from_numpy(x_np).to(cuda), torch.from_numpy(val_np).to(cuda)
    sched = rs.build_schedule(ptr)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    launches = mm.spmv_minmax_pull.launches
    y = mm.spmv_minmax_pull(ptr, ind, val, x, sr, n_out, sched=sched)
    y2 = mm.spmv_minmax_pull(ptr, ind, val, x, sr, n_out, sched=sched)
    torch.cuda.synchronize()
    assert mm.spmv_minmax_pull.launches == launches + 2
    assert y.dtype == x.dtype and y.shape == (n_out,)
    assert torch.equal(_bits(y), _bits(y2))
    cpu = mm.spmv_minmax_pull_plain(ptr.cpu(), ind.cpu(), val.cpu(), x.cpu(),
                                    sr, n_out)
    np.testing.assert_array_equal(y.cpu().numpy(), cpu.numpy())
    assert _same(y, mm.spmv_minmax_pull_plain(ptr, ind, val, x, sr, n_out))
    empty = torch.from_numpy(length == 0).to(cuda)
    assert bool((y[empty] == sr.identity(x.dtype).to(cuda)).all())


def test_minmax_pull_refuses_a_call_without_a_schedule(cuda):
    """A CUDA launch of S without its row schedule, or with another
    row count's, raises; a dtype or semiring it does not take raises."""
    ptr = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    ind = torch.tensor([0], dtype=torch.int32, device=cuda)
    val = torch.ones(1, dtype=torch.int32, device=cuda)
    x = torch.arange(5, 9, dtype=torch.int32, device=cuda)
    sr = tgb.MaximumMultipliesSemiring
    with pytest.raises(ValueError, match="schedule"):
        mm.spmv_minmax_pull(ptr, ind, val, x, sr, 2)
    with pytest.raises(ValueError, match="schedule"):
        mm.spmv_minmax_pull(ptr, ind, val, x, sr, 2, sched=rs.build_schedule(
            torch.tensor([0, 1], dtype=torch.int32, device=cuda)))
    with pytest.raises(ValueError):
        mm.spmv_minmax_pull(ptr, ind, val, x.double(), sr, 2,
                            sched=rs.build_schedule(ptr))
    y = mm.spmv_minmax_pull(ptr, ind, val, x, sr, 2,
                            sched=rs.build_schedule(ptr))
    assert y.tolist() == [5, 0]   # x[0] * 1, and the empty row's identity


def _on_cpu(ops):
    return tuple(None if t is None else t.cpu() for t in ops)


def _schedules(ops, fold=True):
    """(budget, all_bitmap, schedule) of the operands `ops` under each of
    ROUTINGS, as the replay builds them."""
    n_ids = _ids_bound(_on_cpu(ops))
    return [(b, ab, isch.build_intersect_schedule(
        ops[0], ops[1], ops[2], ops[5], n_ids, fold, b, all_bitmap=ab))
        for b, ab in ROUTINGS]


def _routes_since(fn, before):
    return {k: fn.routes[k] - before[k] for k in before}


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_masked_intersect_matches_replay_on_the_card(cuda, name, dtype,
                                                     transpose_b):
    """On each routing of the schedule (by cost, all bitmap, all search):
    T2 bitwise equal to the CPU replay of its walk and fold order and to
    a second launch, within its tolerance of the plain version; T1 equal
    to the replay's count. Each launch counted once, and its edges once
    on the route the schedule gave them."""
    _, (A, B, M) = fuzz_matrices(5, dtype, device=cuda)
    ops = sg._operands(A, B, M, transpose_b)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    plain = mx.masked_intersect_fold_plain(*ops, sr).cpu().numpy()
    for budget, all_bitmap, sched in _schedules(ops):
        folds, counts = mx.masked_intersect_fold.launches, \
            mx.masked_intersect_count.launches
        routes = dict(mx.masked_intersect_fold.routes)
        c = mx.masked_intersect_fold(*ops, sr, sched=sched)
        c2 = mx.masked_intersect_fold(*ops, sr, sched=sched)
        count = mx.masked_intersect_count(*sg._count_args(ops), sched=sched)
        torch.cuda.synchronize()
        assert mx.masked_intersect_fold.launches == folds + 2
        assert mx.masked_intersect_count.launches == counts + 1
        assert _routes_since(mx.masked_intersect_fold, routes) == {
            k: 2 * v for k, v in sched.routes.items()}
        assert sum(sched.routes.values()) == M.nvals
        assert torch.equal(_bits(c), _bits(c2))
        want_count, want, sides, taken = replay_ops(
            _on_cpu(ops), name, dtype, budget=budget, all_bitmap=all_bitmap)
        assert taken == set(sched.bitmap.tolist())
        assert count == want_count
        np.testing.assert_array_equal(c.cpu().numpy().view(np.int32),
                                      want.view(np.int32))
        if name.startswith("Plus") and dtype == np.float32:
            np.testing.assert_allclose(
                c.cpu().numpy(), plain, rtol=1e-5,
                atol=1e-5 * float(np.abs(plain).max()))
        else:
            np.testing.assert_array_equal(c.cpu().numpy(), plain)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_masked_intersect_on_nested_lists_on_the_card(cuda, name, dtype,
                                                      transpose_b):
    """T2 bitwise equal to the CPU replay on `nested_coo` (walked lists
    matched in full, empty lists, negative products), on each routing of
    the schedule, where the identity joins only as the JAX join brings it
    in: the masked mxm's rule, and the trace's over the diagonal pairs."""
    _, (A, B, M) = fuzz_matrices(2, dtype, device=cuda, make=nested_coo,
                                 transpose_b=transpose_b)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    for ops, trace in ((sg._operands(A, B, M, transpose_b), False),
                       (sg._diagonal_operands(A, B), True)):
        for budget, all_bitmap, sched in _schedules(ops):
            c = mx.masked_intersect_fold(*ops, sr, trace=trace, sched=sched)
            _, want, _, _ = replay_ops(_on_cpu(ops), name, dtype,
                                       trace=trace, budget=budget,
                                       all_bitmap=all_bitmap)
            np.testing.assert_array_equal(c.cpu().numpy().view(np.int32),
                                          want.view(np.int32))
            if not (name.startswith("Plus") and dtype == np.float32):
                assert torch.equal(c, mx.masked_intersect_fold_plain(
                    *ops, sr, trace=trace))


def _hub_graph(cuda, n, m, hubs, hub_deg, seed):
    """A symmetric graph of n vertices: m random edges and `hubs` vertices
    with hub_deg more each, so that hub x hub mask edges walk lists of
    thousands of ids."""
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    h = rng.integers(0, n, hubs)
    rows = np.r_[rows, np.repeat(h, hub_deg)]
    cols = np.r_[cols, rng.integers(0, n, hubs * hub_deg)]
    from graphblast_tpu_torch.io.mmio import canonicalize_coo

    r, c, v = canonicalize_coo(rows, cols, np.ones(len(rows), np.float32),
                               undirected=True, remove_self_loops=True)
    v = rng.uniform(0.5, 2.0, len(r)).astype(np.float32)
    return tgb.Matrix.from_coo(r, c, v, n, n, device=cuda)


@pytest.mark.parametrize("transpose_b", [False, True])
def test_masked_intersect_on_hub_lists_on_the_card(cuda, transpose_b):
    """Lists of thousands of ids (many rounds of the 32 lanes, long
    searches): T1 equal to the plain count and T2 MinimumPlus equal to the
    plain version, PlusMultiplies within 1e-5·max|c| of its float64 plain
    version, bitwise equal to a second launch."""
    A = _hub_graph(cuda, 6000, 40000, 4, 3000, 17)
    L = tgb.tril(A)
    for X in (A, L):
        ops = sg._operands(X, X, X, transpose_b)
        args = sg._count_args(ops)
        assert mx.masked_intersect_count(*args) == \
            mx.masked_intersect_count_plain(*args)
        mp_ = mx.masked_intersect_fold(*ops, tgb.MinimumPlusSemiring)
        assert torch.equal(mp_, mx.masked_intersect_fold_plain(
            *ops, tgb.MinimumPlusSemiring))
        c = mx.masked_intersect_fold(*ops, tgb.PlusMultipliesSemiring)
        assert torch.equal(_bits(c), _bits(mx.masked_intersect_fold(
            *ops, tgb.PlusMultipliesSemiring)))
        d_ops = ops[:4] + (ops[4].double(),) + ops[5:7] + (ops[7].double(),)
        want = mx.masked_intersect_fold_plain(*d_ops,
                                              tgb.PlusMultipliesSemiring)
        err = float((c.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


def test_tc_and_masked_mxm_on_the_card(cuda):
    """tc at RMAT scale 12 equal to the host golden and the plain count,
    one T1 launch a call; triangle_count, the general mxm route (one T2
    launch) and trace_mxm_transpose (one T2 launch) against their plain
    versions."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    L = tgb.tril(A)
    counts = mx.masked_intersect_count.launches
    routes = dict(mx.masked_intersect_count.routes)
    got = tgb.algorithms.tc(L)
    assert mx.masked_intersect_count.launches == counts + 1
    taken = _routes_since(mx.masked_intersect_count, routes)
    assert sum(taken.values()) == L.nvals and taken["bitmap"] > 0
    assert got == tgb.algorithms.tc_cpu(L)
    assert got == sg.spgemm_masked_count_plain(L, L, L, transpose_b=True)
    assert got == tgb.algorithms.triangle_count(A)
    folds = mx.masked_intersect_fold.launches
    C = tgb.mxm(L, L, tgb.PlusMultipliesSemiring, mask=L,
                desc=tgb.Descriptor(transpose_inp1=True))
    assert mx.masked_intersect_fold.launches == folds + 1
    assert int(C.val[: C.nvals].round().long().sum()) == got
    P = sg.spgemm_masked_plain(L, L, L, tgb.PlusMultipliesSemiring,
                               transpose_b=True)
    assert torch.equal(C.val, P.val)      # small integer sums are exact
    tr = tgb.trace_mxm_transpose(A, A, tgb.PlusMultipliesSemiring)
    assert mx.masked_intersect_fold.launches == folds + 2
    assert float(tr) == float(sg.intersect_rows_reduce_plain(
        A, A, tgb.PlusMultipliesSemiring)) == float(A.nvals)


def test_masked_intersect_past_the_budget_on_the_card(cuda):
    """n = 2^21 vertices, whose bitmap (256 KB for T1, 512 KB with T2's
    prefix counts) passes the shared-memory budget: tc, the masked mxm and
    the trace take the search route alone, one launch each, and equal
    their plain versions (PlusMultiplies within 1e-5·max|c|; small integer
    sums here are exact)."""
    n, m = 1 << 21, 3_000_000
    g = torch.Generator(device=cuda)
    g.manual_seed(21)
    e = torch.randint(0, n, (2, m), generator=g, device=cuda)
    r, c = torch.cat([e[0], e[1]]), torch.cat([e[1], e[0]])
    from graphblast_tpu_torch.io.mmio import canonicalize_coo

    rr, cc, vv = canonicalize_coo(r.cpu().numpy(), c.cpu().numpy(),
                                  np.ones(2 * m, np.float32),
                                  undirected=True, remove_self_loops=True)
    A = tgb.Matrix.from_coo(rr, cc, vv, n, n, device=cuda)
    L = tgb.tril(A)
    assert L.ncols // 8 > isch.SMEM_BUDGET
    before = {fn: (fn.launches, dict(fn.routes)) for fn in
              (mx.masked_intersect_count, mx.masked_intersect_fold)}
    assert tgb.algorithms.tc(L) == sg.spgemm_masked_count_plain(
        L, L, L, transpose_b=True)
    C = sg.spgemm_masked(L, L, L, tgb.PlusMultipliesSemiring,
                         transpose_b=True)
    P = sg.spgemm_masked_plain(L, L, L, tgb.PlusMultipliesSemiring,
                               transpose_b=True)
    assert torch.equal(C.val, P.val)
    tr = sg.intersect_rows_reduce(A, A, tgb.MinimumPlusSemiring)
    assert torch.equal(tr, sg.intersect_rows_reduce_plain(
        A, A, tgb.MinimumPlusSemiring))
    count, fold = (mx.masked_intersect_count, mx.masked_intersect_fold)
    assert count.launches == before[count][0] + 1
    assert fold.launches == before[fold][0] + 2
    assert _routes_since(count, before[count][1]) == {
        "bitmap": 0, "search": L.nvals}
    assert _routes_since(fold, before[fold][1]) == {
        "bitmap": 0, "search": L.nvals + A.nrows}


def test_masked_fold_refuses_on_the_card(cuda):
    """The ordered folds (GreaterPlus, CustomLessPlus, CustomLessLess,
    NotEqualToPlus, MultipliesMultiplies) on float32 and int32 launch the
    ordered kernel, bitwise equal to their plain version and the Python
    replay, with nothing falling back to the plain version; a dtype T2
    does not fold raises, and PlusDivides on int32 raises TypeError, as
    the JAX spgemm_masked does."""
    for (name, dtype), transpose_b, long_lists in itertools.product(
            ORDERED_DTYPES, (False, True), (False, True)):
        if long_lists:   # several 32-lane rounds and a partial one
            _, (A, B, M) = fuzz_matrices(0, dtype, device=cuda,
                                         make=_long_lists_coo,
                                         transpose_b=transpose_b)
        else:            # hub rows: both sides walked
            _, (A, B, M) = fuzz_matrices(1, dtype, device=cuda)
        ops = sg._operands(A, B, M, transpose_b)
        before = (mx.masked_intersect_fold.launches,
                  mx.masked_intersect_fold.ordered_launches)
        got = mx.masked_intersect_fold(*ops, _sr(name))
        assert (mx.masked_intersect_fold.launches,
                mx.masked_intersect_fold.ordered_launches) == (
                    before[0], before[1] + 1)
        want = mx.masked_intersect_fold_plain(*ops, _sr(name))
        assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
        with np.errstate(all="ignore"):
            replay = replay_ordered(_on_cpu(ops), name, dtype)
        assert got.cpu().numpy().tobytes() == replay.tobytes()
    _, (A, B, M) = fuzz_matrices(1, device=cuda)
    ops = sg._operands(A, B, M, True)
    d_ops = ops[:4] + (ops[4].double(),) + ops[5:]
    with pytest.raises(NotImplementedError):
        mx.masked_intersect_fold(*d_ops, tgb.PlusMultipliesSemiring)
    i_ops = ops[:4] + (ops[4].int(),) + ops[5:]
    with pytest.raises(TypeError):
        mx.masked_intersect_fold(*i_ops, tgb.semiring.PlusDividesSemiring)


# ------------------------------------------------------------- the push
def _hand_kernel_launches():
    """Launch counts of every hand kernel but the gather K6; the bitmap
    push P last."""
    return (bp.spmv_bitmap_pull.launches, vp.spmv_value_pull.launches,
            mp.spmv_monoid.launches, ko.orpull_bit_csum.launches,
            mm.spmv_minmax_pull.launches, mx.masked_intersect_count.launches,
            mx.masked_intersect_fold.launches,
            bpush.spmspv_push_bitmap.launches)


PUSH_CARD_CASES = [
    # (semiring, structure_only, sort_push, masked, values)
    ("LogicalOrAndSemiring", True, True, True, "ones"),
    ("LogicalOrAndSemiring", True, False, True, "ones"),
    ("MinimumPlusSemiring", False, True, False, "uniform"),
    ("MinimumPlusSemiring", False, False, False, "uniform"),
    ("MaximumMultipliesSemiring", False, True, True, "uniform"),
    ("PlusMultipliesSemiring", False, True, False, "normal"),
    ("PlusMultipliesSemiring", False, False, False, "normal"),
    ("MultipliesMultipliesSemiring", False, True, False, "pow2"),
]


def _push_on(device, sr_name, struc, sort_push, masked, values, transpose):
    """mxv_dual PUSHONLY at RMAT scale 12 on `device`, from a seeded 3%
    frontier: (dense, sind, sval, snvals) on the host."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    A = rmat_matrix(12, 16, seed=42, device=device)
    rng = np.random.default_rng(12)
    sr = getattr(tgb.semiring, sr_name)
    ident = float(sr.identity(torch.float32))
    n = A.nrows
    pick = rng.random(n) < 0.03
    x = np.full(n, ident, np.float32)
    x[pick] = {"ones": np.ones, "uniform": lambda k: rng.random(k) * 3 + 0.5,
               "normal": rng.standard_normal,
               "pow2": lambda k: rng.choice([0.5, 1.0, 2.0, -1.0], k)}[
                   values](int(pick.sum()))
    mask = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    f = DualFrontier.from_dense(torch.from_numpy(x).to(device), ident)
    f2, used_push = mxv_dual(
        A, f, sr, ident, transpose=transpose, structure_only=struc,
        sort_push=sort_push, mask_dense=mask.to(device) if masked else None,
        mask_scmp=True, mode=tgb.Direction.PUSHONLY)
    assert used_push
    return tuple(None if t is None else t.cpu()
                 for t in (f2.dense, f2.sind, f2.sval, f2.snvals))


@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
@pytest.mark.parametrize("sr_name,struc,sort_push,masked,values",
                         PUSH_CARD_CASES)
def test_push_on_the_card_matches_the_cpu(cuda, sr_name, struc, sort_push,
                                          masked, values, transpose):
    """The push on the card equals the CPU's plain run: exact, but for the
    Plus sums (rtol 1e-5, atol 1e-5: another order within a segment, and
    the SIMPLE push's atomics); the MERGE push and the bitmap push are
    bitwise equal across two runs on the card, as is the scatter push in
    slices that every Min and Max valued push takes, whatever sort_push
    says. The structure-only LogicalOr push launches the bitmap push once
    and no K6, whatever sort_push says; every other push launches K6 and
    no other kernel."""
    args = (sr_name, struc, sort_push, masked, values, transpose)
    k6 = kg.gather_1d.launches
    others = _hand_kernel_launches()
    card = _push_on(cuda, *args)
    bitmap = struc and sr_name == "LogicalOrAndSemiring"
    after = _hand_kernel_launches()
    assert after[:-1] == others[:-1]
    assert after[-1] - others[-1] == int(bitmap)
    assert (kg.gather_1d.launches > k6) != bitmap
    cpu = _push_on("cpu", *args)
    k = int(cpu[3])
    assert int(card[3]) == k
    assert torch.equal(card[1][:k], cpu[1][:k])
    plus = sr_name == "PlusMultipliesSemiring"
    for got, want in ((card[0], cpu[0]), (card[2], cpu[2])):
        if want is None:
            assert got is None
        elif plus:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert torch.equal(got, want)
    if sort_push or bitmap or sr_name in ("MinimumPlusSemiring",
                                          "MaximumMultipliesSemiring"):
        again = _push_on(cuda, *args)
        for a, b in zip(card, again):
            assert (a is None and b is None) or torch.equal(a, b)


def test_push_bfs_and_sssp_on_the_card_launch_k6_per_iteration(
        cuda, monkeypatch):
    """PUSHONLY BFS and SSSP from the hub at RMAT scale 12 equal the
    goldens; a BFS push iteration (structure-only) launches the bitmap
    push once and no K6; an SSSP one, a scatter push of one lane an edge
    over slices of the frontier, launches K6 6 times a slice (2 row-pointer
    gathers, the lanes' edge bases, the adjacency and the 2 value gathers;
    no fill and a dense filter), and 2 more for the cut's
    degree gathers where its frontier passes the second tier, all at
    ascending indices, and no other hand kernel runs."""
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused
    from graphblast_tpu_torch.io.rmat import rmat_matrix
    from graphblast_tpu_torch.ops import dispatch

    slices = []
    inner = dispatch.slice_bounds

    def recording(ptr, sind, snvals, lanes, deg_total):
        out = inner(ptr, sind, snvals, lanes, deg_total)
        if deg_total > lanes:
            slices.append(len(out))
        return out

    monkeypatch.setattr(dispatch, "slice_bounds", recording)
    A = rmat_matrix(12, 16, seed=42, device=cuda)
    s = int(np.argmax(np.diff(A.host_csr()[0])))
    others = _hand_kernel_launches()
    k6, k6_sorted = kg.gather_1d.launches, kg.gather_1d.sorted_launches
    levels = tgb.algorithms.bfs(A, s, tgb.BFS_TUNED.replace(
        mxv_mode=tgb.Direction.PUSHONLY)).to_numpy()
    np.testing.assert_array_equal(levels, tgb.algorithms.bfs_cpu(A, s))
    assert kg.gather_1d.launches == k6
    assert kg.gather_1d.sorted_launches == k6_sorted
    push = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PUSHONLY)
    dist = tgb.algorithms.sssp(A, s, push).to_numpy()
    np.testing.assert_array_equal(dist, tgb.algorithms.sssp_cpu(A, s))
    ran = kg.gather_1d.launches - k6
    assert kg.gather_1d.sorted_launches - k6_sorted == ran
    sliced = list(slices)
    _, it = _sssp_fused(A, s, None, switchpoint=0.01,
                        mode=tgb.Direction.PUSHONLY, max_niter=1000)
    assert sliced and len(sliced) < it
    assert ran == 6 * (it - len(sliced)) + sum(2 + 6 * k for k in sliced)
    after = _hand_kernel_launches()
    assert after[:-1] == others[:-1]
    assert after[-1] - others[-1] == int(levels.max())


# the bitmap push's cases: (name, what it exercises)
BITMAP_PUSH_CARD_CASES = [
    "random",      # rows of Poisson(12) edges, a 5% frontier, n = 50,001
    "rmat12", "rmat14",   # a 1/30 frontier and the hub
    "hub",         # a row of 200,000 edges over 49 blocks, two small rows
    "deg4095", "deg4096", "deg4097",   # degree totals E - 1, E, E + 1
    "many_slots",  # 20,000 slots of 0 and 1 edges: 8,192 slots a block
]


def _bitmap_push_inputs(case, rng):
    """(ptr, ind, the frontier's ids, n) on the host."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    if case.startswith("rmat"):
        A = rmat_matrix(int(case[4:]), 16, seed=42, device="cpu")
        deg = np.diff(A.host_csr()[0])
        ids = np.append(rng.choice(A.nrows, A.nrows // 30, replace=False),
                        np.argmax(deg))
        return A.row_ptr, A.col_ind, np.unique(ids), A.nrows
    n = 50_001
    lens = rng.integers(0, 4, n)
    if case == "random":
        lens = rng.poisson(12, n)
        ids = rng.choice(n, n // 20, replace=False)
    elif case == "hub":
        lens[7] = 200_000
        ids = np.array([3, 7, 40_000])
    elif case.startswith("deg"):
        # slots of total - 5, 2, 0 and 3 edges
        lens[[10, 20, 25, 30]] = [int(case[3:]) - 5, 2, 0, 3]
        ids = np.array([10, 20, 25, 30])
    else:
        lens[:20_000] = np.arange(20_000) % 2
        ids = np.arange(20_000)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ind = rng.integers(0, n, int(ptr[-1])).astype(np.int32)
    return torch.from_numpy(ptr), torch.from_numpy(ind), np.unique(ids), n


@pytest.mark.parametrize("mask_kind", ["none", "scmp", "mask"])
@pytest.mark.parametrize("case", BITMAP_PUSH_CARD_CASES)
def test_bitmap_push_kernel_matches_plain_on_the_card(cuda, case,
                                                      mask_kind):
    """The bitmap push P on the card equals its plain version on the CPU
    and a second launch, bit for bit: y, sind, nv and no values."""
    rng = np.random.default_rng(len(case) * 7 + len(mask_kind))
    ptr, ind, ids, n = _bitmap_push_inputs(case, rng)
    f_ind = np.full(n, n, np.int32)
    f_ind[:len(ids)] = ids
    p = ptr.numpy().astype(np.int64)
    deg_total = int((p[ids + 1] - p[ids]).sum())
    if case.startswith("deg"):
        assert deg_total == int(case[3:])
    v = torch.from_numpy(((rng.random(n) < 0.4)
                          * rng.random(n)).astype(np.float32))
    mask = None if mask_kind == "none" else v
    args = (torch.from_numpy(f_ind), len(ids), deg_total, mask,
            mask_kind == "scmp", n)
    want = bpush.spmspv_push_bitmap_plain(ptr, ind, *args)
    card = (ptr.to(cuda), ind.to(cuda), args[0].to(cuda), *args[1:3],
            None if mask is None else mask.to(cuda), *args[4:])
    launches = bpush.spmspv_push_bitmap.launches
    got = bpush.spmspv_push_bitmap(*card)
    again = bpush.spmspv_push_bitmap(*card)
    torch.cuda.synchronize()
    assert bpush.spmspv_push_bitmap.launches == launches + 2
    assert int(want[3]) > 0
    for out in (got, again):
        assert out[2] is None
        assert torch.equal(out[0].cpu(), want[0])
        assert torch.equal(out[1].cpu(), want[1])
        assert out[3].dtype == torch.int32 and int(out[3]) == int(want[3])


# (graph, switchpoint): RMAT 12 from its hub under the default switchpoint,
# RMAT 14 at 0.5 (the hub's second push finds 8,640 vertices and the run
# switches both ways), and a 64 x 64 grid
PUSHPULL_CARD_CASES = [("rmat12", 0.01), ("rmat14", 0.5), ("grid64", 0.01)]


def _pushpull_graph(name, device):
    from graphblast_tpu_torch.io.rmat import grid_matrix, rmat_matrix

    if name == "grid64":
        return grid_matrix(64, device=device)
    return rmat_matrix(int(name[4:]), 16, seed=42, device=device)


@pytest.mark.parametrize("valued", [False, True],
                         ids=["structure", "valued"])
@pytest.mark.parametrize("name,switchpoint", PUSHPULL_CARD_CASES,
                         ids=[c[0] for c in PUSHPULL_CARD_CASES])
def test_pushpull_on_the_card_matches_the_cpu(cuda, name, switchpoint,
                                              valued):
    """The default BFS (PUSHPULL), fused and stepped, and diameter over
    sources [0, 8), on the card equal the same calls on the CPU (the
    kernels' plain versions) and the golden; exact. `valued` turns
    structure_only off, so the BFS pushes the frontier's values through
    mxv_dual's workspace route instead of the bitmap push; the structure
    case also runs the default SSSP the same way."""
    A = _pushpull_graph(name, cuda)
    C = _pushpull_graph(name, "cpu")
    s = int(np.argmax(np.diff(C.host_csr()[0])))
    bdesc = tgb.BFS_TUNED.replace(switchpoint=switchpoint,
                                  structure_only=not valued)
    sdesc = tgb.DEFAULT.replace(switchpoint=switchpoint)
    for mode in ("fused", "stepped"):
        want = tgb.algorithms.bfs(C, s, bdesc, mode=mode).to_numpy()
        np.testing.assert_array_equal(want, tgb.algorithms.bfs_cpu(C, s))
        np.testing.assert_array_equal(
            tgb.algorithms.bfs(A, s, bdesc, mode=mode).to_numpy(), want)
        if valued:
            continue
        want = tgb.algorithms.sssp(C, s, sdesc, mode=mode).to_numpy()
        np.testing.assert_array_equal(want, tgb.algorithms.sssp_cpu(C, s))
        np.testing.assert_array_equal(
            tgb.algorithms.sssp(A, s, sdesc, mode=mode).to_numpy(), want)
    assert tgb.diameter(A, 0, 8, bdesc) == tgb.diameter(C, 0, 8, bdesc)


# --------------------------------------- the operations surface on the card
def _to(M, dev):
    return dataclasses.replace(M, **{
        k: None if getattr(M, k) is None else getattr(M, k).to(dev)
        for k in tgb.matrix.LEAVES}, _plans={})


def _within(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want[np.abs(want) < 3e38]).max(
            initial=0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


# a non-associative ⊕'s push folds in its sort's order: GreaterPlus pulls
MATVEC_CARD_CASES = [(s, p) for s in ("LogicalOrAnd", "MinimumPlus",
                                      "PlusMultiplies", "MaximumMultiplies",
                                      "PlusMinus", "GreaterPlus")
                     for p in (False, True) if not (p and s == "GreaterPlus")]


@pytest.mark.parametrize("sr_name,sparse", MATVEC_CARD_CASES)
@pytest.mark.parametrize("fn", ["mxv", "vxm"])
def test_matvec_on_the_card_matches_the_cpu(cuda, sr_name, sparse, fn):
    """mxv and vxm on the card, pull (dense u) and push (sparse u), with a
    complemented mask, a Plus accumulator and w, equal to the same call on
    the CPU (the plain kernels): exact but for float sums (1e-5·max|y|)."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    sr = getattr(tgb, sr_name + "Semiring")
    A = rmat_matrix(11, 16, seed=5, device="cpu")
    rng = np.random.default_rng(len(sr_name))
    n = A.nrows
    x = np.where(rng.random(n) < 0.6, 0, rng.standard_normal(n)).astype(
        np.float32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    desc = tgb.Descriptor(mask_scmp=True,
                          structure_only=sr_name == "LogicalOrAnd")
    outs = []
    for M, dev in ((A, "cpu"), (_to(A, cuda), cuda)):
        u = tgb.Vector.dense_from(x, device=dev)
        if sparse:
            u = u.to_sparse(0)
        args = (M, u) if fn == "mxv" else (u, M)
        y = getattr(tgb, fn)(*args, sr, mask=tgb.Vector.dense_from(
            mask, device=dev), accum=tgb.PlusMonoid, desc=desc,
            w=tgb.Vector.dense_from(w, device=dev))
        assert y.storage == (tgb.Storage.SPARSE if sparse
                             else tgb.Storage.DENSE)
        outs.append(y.to_numpy(sr.identity(torch.float32).item()))
    _within(outs[1], outs[0], sr.add.name != "PlusMonoid")


@pytest.mark.parametrize("sr_name", ["PlusMultiplies", "MinimumPlus",
                                     "LogicalOrAnd"])
@pytest.mark.parametrize("max_lanes", [1 << 23, 4096])
def test_spgemm_esc_on_the_card_matches_the_cpu(cuda, sr_name, max_lanes):
    """The ESC C = A·A at RMAT scale 10 with seeded symmetric integer
    weights in 1..8 on the card: every array equal to the CPU's (exact:
    every sum is an integer below 2^24), in one chunk and in many (the
    merge); 10 K6 launches a chunk; C equal to scipy's A·A under
    PlusMultiplies and to a NumPy golden under MinimumPlus."""
    import scipy.sparse as sp

    from graphblast_tpu_torch.io.rmat import rmat_matrix

    sr = getattr(tgb, sr_name + "Semiring")
    A0 = rmat_matrix(10, 16, seed=3, device="cpu")
    ptr, ind, _ = A0.host_csr()
    n = A0.nrows
    r = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    c = ind.astype(np.int64)
    _, pair = np.unique(np.minimum(r, c) * n + np.maximum(r, c),
                        return_inverse=True)
    w = np.random.default_rng(31).integers(1, 9, pair.max() + 1)[pair]
    A = tgb.Matrix.from_coo(r, c, w.astype(np.float32), n, n, device="cpu")
    assert A.symmetric
    want = sg.spgemm_esc(A, A, sr, max_lanes=max_lanes)
    ptr, ind, val = A.host_csr()
    if sr_name == "PlusMultiplies":
        S = sp.csr_matrix((val, ind, ptr), shape=A.shape)
        gold = S @ S
        gold.sort_indices()
        gold = (gold.indptr, gold.indices, gold.data)
    elif sr_name == "MinimumPlus":
        # every product A[i,k] + A[k,j], then the min for each (i, j)
        cnt = np.diff(ptr)[c]
        src = np.repeat(np.arange(len(c)), cnt)
        pos = (np.repeat(ptr[c], cnt) + np.arange(cnt.sum())
               - np.repeat(np.cumsum(cnt) - cnt, cnt))
        key = r[src] * n + ind[pos]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        heads = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        mins = np.minimum.reduceat((val[src] + val[pos])[order], heads)
        gold = (np.r_[0, np.cumsum(np.bincount(ks[heads] // n,
                                               minlength=n))],
                ks[heads] % n, mins)
    if sr_name != "LogicalOrAnd":
        for a, b in zip(want.host_csr(), gold):
            np.testing.assert_array_equal(a, b)
    Ac = _to(A, cuda)
    chunks = len(sg.esc_plan(Ac, Ac, max_lanes=max_lanes)[1]) - 1
    launches = kg.gather_1d.launches
    got = sg.spgemm_esc(Ac, Ac, sr, max_lanes=max_lanes)
    assert kg.gather_1d.launches - launches == 10 * chunks
    assert (got.nvals, got.symmetric, got.format) == (
        want.nvals, want.symmetric, want.format)
    for leaf in tgb.matrix.LEAVES:
        a, b = getattr(want, leaf), getattr(got, leaf)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(b.cpu(), a), leaf


def test_lgc_and_mxm_dense_on_the_card_match_the_cpu(cuda):
    """lgc from the hub at RMAT scale 12 within rtol 1e-3 / atol 1e-7 of
    the CPU's, with 2·iterations + 1 K6 launches; mxm_dense under Plus
    (1e-5·max|C|) and Min (exact)."""
    from graphblast_tpu_torch.algorithms.lgc import _lgc_loop
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device="cpu")
    s = int(np.argmax(np.diff(A.host_csr()[0])))
    Ac = _to(A, cuda)
    want = tgb.lgc(A, s).to_numpy()
    launches = kg.gather_1d.launches
    got = tgb.lgc(Ac, s).to_numpy()
    iters = _lgc_loop(A, s, alpha=0.15, eps=1e-6, max_niter=10000)[2]
    assert kg.gather_1d.launches - launches == 2 * iters + 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)
    B = np.random.default_rng(1).standard_normal((A.ncols, 8)).astype(
        np.float32)
    for sr in (tgb.PlusMultipliesSemiring, tgb.MinimumPlusSemiring):
        c_cpu = tgb.mxm_dense(A, B, sr).numpy()
        c_gpu = tgb.mxm_dense(Ac, torch.from_numpy(B).to(cuda), sr)
        if sr.add.name == "PlusMonoid":
            np.testing.assert_allclose(c_gpu.cpu().numpy(), c_cpu, rtol=0,
                                       atol=1e-5 * np.abs(c_cpu).max())
        else:
            np.testing.assert_array_equal(c_gpu.cpu().numpy(), c_cpu)


def test_driver_memory_flag_prints_the_cards_memory(cuda, capsys):
    """gbfs --memory on the card prints one line: the bytes in use on the
    card after the runs and the most torch allocated, both above 0."""
    from graphblast_tpu_torch.examples import gbfs

    assert gbfs.main(["rmat:10:16", "--niter", "1", "--memory"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("memory: ")]
    assert len(lines) == 1
    nums = [int(w) for w in lines[0].split() if w.isdigit()]
    assert len(nums) == 3 and nums[0] > 0 and nums[2] > 0
    assert nums[0] <= nums[1]


@pytest.mark.parametrize("order", ["canonical", "shuffled"])
def test_matrix_build_on_the_card_equals_the_cpu_build(cuda, order):
    """Matrix.from_coo on the card, over chunks of 4,096 entries, gives the
    CPU build's tensors (held to the JAX package's in
    test_torch_matrix_build.py), and MemorySteps hears every step."""
    from graphblast_tpu_torch import matrix as tm
    from graphblast_tpu_torch.io.mmio import canonicalize_coo
    from graphblast_tpu_torch.io.rmat import rmat_edges
    from graphblast_tpu_torch.utils.profiling import MemorySteps

    r, c = rmat_edges(12, 16, 0)
    r, c, v = canonicalize_coo(r, c, np.ones(len(r), np.float32),
                               undirected=True, remove_self_loops=True)
    if order == "shuffled":
        perm = np.random.default_rng(0).permutation(len(r))
        r, c, v = r[perm], c[perm], v[perm]
    n = 1 << 12
    old, tm._CHUNK = tm._CHUNK, 4096
    try:
        rec = MemorySteps()
        G = tgb.Matrix.from_coo(r, c, v, n, n, device="cuda", steps=rec)
        H = tgb.Matrix.from_coo(r, c, v, n, n, device="cpu")
    finally:
        tm._CHUNK = old
    assert G.symmetric and H.symmetric
    for leaf in tm.LEAVES:
        assert torch.equal(getattr(G, leaf).cpu(), getattr(H, leaf)), leaf
    assert [name for name, _, _ in rec.rows][-3:] == [
        "symmetry test", "cast", "host copies"]
    assert rec.peak() > 0
