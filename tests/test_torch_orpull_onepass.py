"""K5, the or-pull prefix count, as the one-pass CUDA kernel computes it, on
the CPU (graphblast_tpu_torch csrc/orpull_csum.cu).

The kernel is one launch over tiles of 8,192 edges, 16 to each of a
block's 512 threads: each block takes
the next tile id from a counter, counts its tile's frontier bits, publishes
that aggregate, looks back over its predecessors' published words (32
tiles at a time) until it meets an inclusive prefix, publishes its own, and
writes its edges' running counts. Inside a tile, thread t holds four groups
of four consecutive edges, group g at 4 (g * 512 + t), and the block
scans the four groups' counts at once as 16-bit fields of one 64-bit word.

Here that decomposition is replayed in NumPy: the packed in-tile scan, the
tile aggregates, and the look-back of each tile with the tiles stepping in a
seeded random order (tiles start in id order, as the counter hands ids out,
and at most `resident` are in flight). Each tile's prefix must be the sum
of the aggregates before it, and the counts must equal
orpull_bit_csum_plain and the JAX package's orpull_bit_csum (the Pallas
kernel in interpret mode), exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblast_tpu.ops.pallas.orpull import orpull_bit_csum as jorpull
from graphblast_tpu_torch.ops.kernels import orpull as ko
from graphblast_tpu_torch.ops.kernels.bitmap_pull import pack_bitmap

NOTHING, AGGREGATE, PREFIX = 0, 1, 2


def _bits(words, col):
    """Each edge's frontier bit; columns past the bitmap, and negative
    ones, read 0."""
    c = col.astype(np.int64)
    inside = (c >= 0) & (c < 32 * len(words))
    if not len(words):
        return np.zeros(len(c), np.int64)
    w = words.view(np.uint32)[np.clip(c >> 5, 0, len(words) - 1)]
    return ((w.astype(np.int64) >> (c & 31)) & 1) * inside


def _tile_scan(bits, threads):
    """A tile's inclusive counts from 0, and its aggregate, as the kernel
    forms them: the four groups' counts of each thread packed into 16-bit
    fields of a uint64, one exclusive scan of the packed words over the
    threads, then each group's prefix and its four running counts."""
    tile = 16 * threads
    b = np.zeros(tile, np.int64)
    b[:len(bits)] = bits
    b = b.reshape(4, threads, 4)                    # [group, thread, edge]
    counts = b.sum(axis=2).astype(np.uint64)        # [group, thread]
    shift = (16 * np.arange(4, dtype=np.uint64))[:, None]
    packed = (counts << shift).sum(axis=0, dtype=np.uint64)
    incl = np.cumsum(packed, dtype=np.uint64)
    excl, total = incl - packed, incl[-1]

    def field(w, g):
        return ((w >> np.uint64(16 * g)) & np.uint64(0xFFFF)).astype(np.int64)

    out = np.zeros((4, threads, 4), np.int64)
    running = 0
    for g in range(4):
        out[g] = running + field(excl, g)[:, None] + np.cumsum(b[g], axis=1)
        running += int(field(total, g))
    assert running == int(b.sum())                  # no field carried
    return out.reshape(-1)[:len(bits)], running


def _look_back(aggs, rng, resident):
    """Each tile's exclusive prefix as the kernel's look-back finds it, the
    tiles stepping in a random order: a step publishes a tile's aggregate
    (tile 0 its prefix), or reads a window of its 32 nearest unsummed
    predecessors (nothing if one of them has published nothing), sums
    them up to the nearest inclusive prefix and publishes its own. Also
    returns how many windows were summed without meeting a prefix."""
    n = len(aggs)
    status = [(NOTHING, 0)] * n
    found = [None] * n
    phase, pred, prefix = {}, {}, {}
    active, next_tile, deep = [], 0, 0
    while active or next_tile < n:
        while len(active) < resident and next_tile < n:
            active.append(next_tile)
            phase[next_tile] = "count"
            next_tile += 1
        t = active[rng.integers(len(active))]
        if phase[t] == "count":
            if t == 0:
                status[0], found[0] = (PREFIX, int(aggs[0])), 0
                active.remove(t)
                continue
            status[t] = (AGGREGATE, int(aggs[t]))
            phase[t], pred[t], prefix[t] = "look", t - 1, 0
            continue
        window = [status[j] if j >= 0 else (PREFIX, 0)
                  for j in range(pred[t], pred[t] - 32, -1)]
        if any(flag == NOTHING for flag, _ in window):
            continue                                # spin
        stop = next((k for k, (flag, _) in enumerate(window)
                     if flag == PREFIX), None)
        prefix[t] += sum(v for _, v in window[:32 if stop is None
                                               else stop + 1])
        if stop is None:
            pred[t] -= 32
            deep += 1
            continue
        status[t] = (PREFIX, prefix[t] + int(aggs[t]))
        found[t] = prefix[t]
        active.remove(t)
    return found, deep


def _one_pass(words, col, threads, seed, resident):
    """csum as the one-pass kernel writes it."""
    tile = 16 * threads
    bits = _bits(words, col)
    scans = [_tile_scan(bits[i:i + tile], threads)
             for i in range(0, len(bits), tile)]
    aggs = np.array([agg for _, agg in scans], np.int64)
    found, _ = _look_back(aggs, np.random.default_rng(seed), resident)
    np.testing.assert_array_equal(found, np.cumsum(aggs) - aggs)
    if not scans:
        return np.zeros(0, np.int32)
    return np.concatenate([p + s for p, (s, _) in zip(found, scans)]).astype(
        np.int32)


def _input(n, m, density, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(n) < density).astype(np.float32)
    col = rng.integers(0, n, m).astype(np.int32)
    k = min(m, 4)
    col[:k] = [n + 40, -1, 32 * ((n + 31) // 32), 1 << 30][:k]  # read 0
    return pack_bitmap(torch.from_numpy(x)).numpy(), col


THREADS = 512   # the kernel's block: tiles of 8,192 edges

# m below one tile, on tile boundaries, one past, a single edge, and several
# tiles
M_CASES = [1, 100, 8191, 8192, 8193, 16384, 2 * 8192 + 3, 5 * 8192 + 7]


@pytest.mark.parametrize("m", M_CASES)
@pytest.mark.parametrize("resident", [1, 3, 40])
def test_one_pass_replay_matches_plain_and_pallas(resident, m):
    """The replay of the tile decomposition and look-back, with 1, 3 or 40
    tiles in flight, vs orpull_bit_csum_plain and the JAX orpull_bit_csum
    (interpret mode), with columns past the bitmap and negative ones."""
    words, col = _input(3000, m, 0.3, m + resident)
    got = _one_pass(words, col, THREADS, seed=m, resident=resident)
    want = ko.orpull_bit_csum_plain(torch.from_numpy(words),
                                    torch.from_numpy(col)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jorpull(
        jnp.asarray(words), jnp.asarray(col), interpret=True)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("resident", [2, 8, 100])
def test_look_back_finds_every_prefix_in_any_order(seed, resident):
    """Tiles stepping in seeded random orders, with 2, 8 or 100 in flight:
    every tile's look-back ends, and finds the sum of the aggregates before
    it; with 100 in flight some look back over more than one window."""
    rng = np.random.default_rng(seed)
    aggs = rng.integers(0, 2049, 150)
    found, deep = _look_back(aggs, np.random.default_rng(seed + 100),
                             resident)
    np.testing.assert_array_equal(found, np.cumsum(aggs) - aggs)
    assert (deep > 0) == (resident > 32)


def test_one_pass_dense_frontier_and_empty_bitmap():
    """Every bit set (each tile's aggregate is its length) and no words at
    all (every count 0), over two tiles and a part of a third."""
    n, m = 4096, 2 * 8192 + 5
    col = np.random.default_rng(1).integers(0, n, m).astype(np.int32)
    words = pack_bitmap(torch.ones(n)).numpy()
    np.testing.assert_array_equal(_one_pass(words, col, THREADS, 0, 8),
                                  np.arange(1, m + 1))
    empty = np.zeros(0, np.int32)
    np.testing.assert_array_equal(_one_pass(empty, col, THREADS, 0, 8),
                                  np.zeros(m))
