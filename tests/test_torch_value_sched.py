"""The row schedule (graphblast_tpu_torch row_schedule.build_schedule) and
the pulls that read rows through it, on the CPU.

The CUDA kernel reads rows through the schedule: rows stably sorted into
six bins by length, each long row cut into CLUSTER chunks (the blocks of
one thread-block cluster), blocks mapped to bins. Here the schedule's
structure is checked, and then the kernel's arithmetic is replayed in
NumPy from the schedule alone: each work item's edges summed in float32, a
long row's chunk sums added in chunk order. That sum must
agree with the plain version, and on positive values and x with the JAX
package's spmv_bilinear (the Pallas kernel in interpret mode), within
1e-5 · max|y|, the bar of tests/test_pallas.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblast_tpu_torch.ops.kernels import row_schedule as rs
from graphblast_tpu_torch.ops.kernels import value_pull as vp

T, K = rs.LONG_ROW, rs.CLUSTER
# the longest row each short bin takes (bins 2-5), and bin 1's
SHORT = {2: 32, 3: 16, 4: 8, 5: 4}


def _rows_random(rng, n_out, m):
    # sorted random rows: many rows empty when m is small against n_out
    return np.sort(rng.integers(0, max(n_out, 1), m))


def _rows_of_lengths(lengths):
    return np.repeat(np.arange(len(lengths)), lengths)


CASES = {
    # name: (n_out, n_in, rows from rng)
    "random": (500, 700, lambda rng: _rows_random(rng, 500, 3000)),
    "mostly_empty": (2000, 300, lambda rng: _rows_random(rng, 2000, 500)),
    "no_rows": (0, 64, lambda rng: np.zeros(0, np.int64)),
    "one_row": (1, 40, lambda rng: np.zeros(21, np.int64)),
    "one_empty_row": (1, 40, lambda rng: np.zeros(0, np.int64)),
    "hub_over_3T": (300, 5000, lambda rng: np.sort(np.r_[
        _rows_random(rng, 300, 4000), np.full(3 * T + 5, 17)])),
    "uniform8": (4096, 4096, lambda rng: np.repeat(np.arange(4096), 8)),
    # one row of each length 0 .. 40, then rows of T and T + 1 edges: each
    # bin's edges on both sides
    "every_length": (43, 900, lambda rng: np.repeat(
        np.arange(43), list(range(41)) + [T, T + 1])),
    # a long row of 2·T + 7 edges, which the chunks do not divide: a
    # shorter last chunk
    "chunk_tail": (200, 3000, lambda rng: _rows_of_lengths(np.insert(
        rng.integers(0, 20, 199), 150, 2 * T + 7))),
    # a long row that the chunks divide exactly
    "exact_chunks": (60, 3000, lambda rng: _rows_of_lengths(np.insert(
        rng.integers(0, 40, 59), 3, 2 * T))),
    # long rows first and last, of different lengths
    "hubs_first_and_last": (100, 4000, lambda rng: _rows_of_lengths(
        [3 * T + 1] + list(rng.integers(0, 50, 98)) + [T + 300])),
    # rows of every bin interleaved, so that perm reorders them all
    "bins_interleaved": (24, 2000, lambda rng: _rows_of_lengths(
        [T + 5, 3, 40, 0, 9, 17] * 4)),
    # only medium rows, up to T edges
    "medium_only": (40, 5000, lambda rng: _rows_of_lengths(
        np.r_[rng.integers(33, 3000, 39), T])),
    # only rows of at most 4 edges
    "short_only": (3000, 500, lambda rng: _rows_of_lengths(
        rng.integers(1, 5, 3000))),
    "all_empty": (50, 10, lambda rng: np.zeros(0, np.int64)),
    # a heavy-tailed degree sequence, as an RMAT graph's
    "heavy_tail": (1500, 3000, lambda rng: _rows_of_lengths(
        np.minimum(rng.zipf(1.8, 1500), 3 * T))),
}


def _case(name, seed=3):
    rng = np.random.default_rng(seed)
    n_out, n_in, make_rows = CASES[name]
    rows = make_rows(rng)
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    x = rng.standard_normal(n_in).astype(np.float32)
    return n_out, n_in, ptr, cols, vals, x


def _bin_of(length):
    if length > T:
        return 0
    if length > 32:
        return 1
    return max(b for b, top in SHORT.items() if length <= top)


def _work_items(sched, ptr):
    """Every block's work, as the kernel reads it: (bin, row, first edge,
    end edge, chunk or -1)."""
    items = []
    perm = sched.perm.numpy()
    chunk_beg = sched.chunk_beg.numpy()
    for blk in range(sched.blocks):
        b = max(i for i in range(rs.N_BINS) if sched.block_begin[i] <= blk)
        if b == 0:
            row = int(perm[blk // K])
            end = (chunk_beg[blk + 1] if blk % K + 1 < K else ptr[row + 1])
            items.append((0, row, int(chunk_beg[blk]), int(end), blk))
            continue
        first = (sched.bin_begin[b]
                 + (blk - sched.block_begin[b]) * rs.ROWS_A_BLOCK[b])
        for k in range(first, min(first + rs.ROWS_A_BLOCK[b],
                                  sched.bin_begin[b + 1])):
            row = int(perm[k])
            items.append((b, row, ptr[row], ptr[row + 1], -1))
    return items


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_covers_every_edge_once(name):
    n_out, _, ptr, _, _, _ = _case(name)
    sched = rs.build_schedule(torch.from_numpy(ptr.astype(np.int32)))
    perm = sched.perm.numpy()
    assert sched.perm.dtype == torch.int32
    # perm is a permutation, stable within each bin, each row in its bin
    np.testing.assert_array_equal(np.sort(perm), np.arange(n_out))
    length = np.diff(ptr)
    assert sched.bin_begin[0] == 0 and sched.bin_begin[-1] == n_out
    for b in range(rs.N_BINS):
        rows = perm[sched.bin_begin[b]:sched.bin_begin[b + 1]]
        assert (np.diff(rows) > 0).all()
        assert all(_bin_of(int(length[r])) == b for r in rows)
    # a long row's K chunks are in edge order, tile the row from its first
    # edge, and differ in length by at most one step of ceil(L / K)
    assert sched.n_chunks == K * sched.bin_rows[0]
    assert sched.block_begin[1] == sched.n_chunks
    for k in range(sched.bin_rows[0]):
        row = int(perm[k])
        beg = np.r_[sched.chunk_beg[K * k:K * (k + 1)].numpy(), ptr[row + 1]]
        assert beg[0] == ptr[row] and (np.diff(beg) >= 0).all()
        assert np.diff(beg).max() == -(-length[row] // K)
    # every edge of [0, ptr[n_out]) is in exactly one work item, and every
    # row is written once: by its item in bins 1-5, or as a long row
    cover = np.zeros(ptr[-1], np.int64)
    written = np.zeros(n_out, np.int64)
    written[perm[:sched.bin_rows[0]]] = 1
    for b, row, beg, end, c in _work_items(sched, ptr):
        assert ptr[row] <= beg <= end <= ptr[row + 1]
        cover[beg:end] += 1
        if c < 0:
            written[row] += 1
    assert (cover == 1).all()
    assert (written == 1).all()


def _replay(sched, ptr, cols, vals, x, n_out):
    """The kernel's sums from the schedule alone: each item in float32, a
    long row's chunk sums added in chunk order."""
    y = np.zeros(n_out, np.float32)
    chunks = np.zeros(sched.n_chunks, np.float32)
    for _, row, beg, end, c in _work_items(sched, ptr):
        s = np.sum(vals[beg:end] * x[cols[beg:end]], dtype=np.float32)
        if c < 0:
            y[row] = s
        else:
            chunks[c] = s
    for k in range(sched.bin_rows[0]):
        total = np.float32(0.0)
        for c in range(K * k, K * (k + 1)):
            total = np.float32(total + chunks[c])
        y[int(sched.perm[k])] = total
    return y


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_sums_match_plain_and_pallas(name):
    from graphblast_tpu.ops.pallas.bilinear import build_plan, spmv_bilinear

    n_out, n_in, ptr, cols, vals, x = _case(name)
    t_ptr = torch.from_numpy(ptr.astype(np.int32))
    sched = rs.build_schedule(t_ptr)
    got = _replay(sched, ptr, cols, vals, x, n_out)
    plan = vp.build_plan(t_ptr, torch.from_numpy(cols.astype(np.int32)),
                         torch.from_numpy(vals), n_out, n_in, sched)
    assert plan.sched is sched
    plain = vp.spmv_value_pull_plain(plan, torch.from_numpy(x)).numpy()
    den = max(np.abs(plain).max(initial=0.0), 1e-9)
    assert got.shape == plain.shape == (n_out,)
    assert np.abs(got - plain).max(initial=0.0) <= 1e-5 * den
    if n_out:   # the Pallas plan needs an output row
        # on positive values and x, as PageRank's: the Pallas kernel's
        # hi/lo bf16 split errs by about 1e-8 of a row's sum of |terms|,
        # more than 1e-5 of the result where a long signed sum cancels
        # (exact_chunks' 16,384-edge row)
        vals, x = np.abs(vals), np.abs(x)
        got = _replay(sched, ptr, cols, vals, x, n_out)
        want = np.asarray(spmv_bilinear(
            build_plan(ptr, cols, vals, n_out, n_in), jnp.asarray(x),
            interpret=True))
        den = max(np.abs(want).max(initial=0.0), 1e-9)
        assert np.abs(got - want).max(initial=0.0) <= 1e-5 * den


def test_plan_checks_its_schedule():
    """A schedule for another row count, or on another device, is refused;
    a CPU plan gets none unless one is handed to it (the launch on the card
    needs one)."""
    import dataclasses

    ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    ind = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert vp.build_plan(ptr, ind, None, 2, 2).sched is None
    other = rs.build_schedule(torch.tensor([0, 3], dtype=torch.int32))
    with pytest.raises(ValueError):
        vp.build_plan(ptr, ind, None, 2, 2, other)
    own = rs.build_schedule(ptr)
    assert vp.build_plan(ptr, ind, None, 2, 2, own).sched is own
    elsewhere = dataclasses.replace(own, perm=own.perm.to("meta"))
    with pytest.raises(ValueError):
        vp.build_plan(ptr, ind, None, 2, 2, elsewhere)
