"""The walk of T1 and T2 (csrc/masked_intersect.cu), replayed on the CPU.

The kernels walk each mask edge with one warp, on the route the
intersection schedule gives it (ops/kernels/intersect_schedule.py). The
search route: the side choice (B's list only when strictly shorter), the
32 lanes striding the walked list, each lane's lower_bound starting where
its last one ended. The bitmap route: A's row staged as a bitmap with
per-word prefix counts, the lanes striding B's list in groups of 4 ids
from its first index that is a multiple of 4 (a lane each for the ids
before it), each hit's A position from the prefix count and a popcount.
Then each lane's fold in walk order from ⊕'s neutral element, a butterfly
over offsets 16, 8, 4, 2, 1, then, for min and max, ⊕ the identity where
the JAX join brings it in (the masked mxm's rule, or the trace's).
`_replay` repeats that in Python with the kernel's arithmetic (float32
rounded once per operation, int32 wrapping, NaN-propagating min and max,
logical ops and comparisons giving 1 or 0) and must equal the plain
versions, which always expand A's side and search B's int64 keys, for every
semiring T2 folds on int32 and float32 values, on inputs whose hub rows make
the walk take both sides, over schedules that send each edge down the
route its cost picks, every edge down the bitmap route, and (with no
shared-memory budget) every edge down the search route. This file imports
no JAX: tests/test_torch_cuda.py holds the kernels bitwise to the same
replay on the card. Tolerances:
counts, min, max, or and int32 exact; Plus on float32 within rtol 1e-5 and
1e-5·max|c| absolute (another order of a sum of signed terms).
"""
import bisect
import os

import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops import spgemm as sp
from graphblast_tpu_torch.ops.kernels import intersect_schedule as isch
from graphblast_tpu_torch.ops.kernels import masked_intersect as mx

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")


def _sr(name):
    return getattr(tgb.semiring, f"{name}Semiring")


def _close(got, want, plus):
    if plus and np.issubdtype(np.asarray(want).dtype, np.floating):
        scale = float(np.max(np.abs(want))) if np.size(want) else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_array_equal(got, want)


def _rand_mat(rng, n, hubs, dtype=np.float32):
    """test_fuzz.py's generator: up to 6n distinct entries, half of them on
    3 hub rows when `hubs`, values in [0.5, 4.5) (int32: in [-9, 9])."""
    m = int(rng.integers(n, n * 6))
    rows = rng.integers(0, n, m)
    if hubs:
        hub = rng.integers(0, n, 3)
        pick = rng.random(m) < 0.5
        rows[pick] = hub[rng.integers(0, 3, int(pick.sum()))]
    cols = rng.integers(0, n, m)
    vals = (rng.random(m) * 4 + 0.5).astype(np.float32)
    key = rows.astype(np.int64) * n + cols
    _, keep = np.unique(key, return_index=True)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if dtype == np.int32:
        vals = rng.integers(-9, 10, len(rows)).astype(np.int32)
    return rows, cols, vals


def fuzz_coo(seed, dtype=np.float32):
    """n and the COO of A, B and M (A and M with hub rows) from a seed."""
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(30, 70))
    return n, [_rand_mat(rng, n, hubs, dtype) for hubs in (True, False, True)]


def nested_coo(seed, dtype=np.float32, transpose_b=True):
    """n and the COO of A, B and M, where most of A's rows and of B's lists
    (its rows when transpose_b, else its columns) are prefixes of one
    shared order of the ids, so that of two such lists one holds the other
    (the walked list is often matched in full) and some are empty; the
    rest are random. A's values are negative, B's positive (int32: in
    [-9, -1] and [1, 9]; float32: magnitudes in [0.5, 4.5)), so every
    product of MaximumMultiplies is negative. M is `_rand_mat`'s, with
    hub rows."""
    rng = np.random.default_rng(900 + seed)
    n = int(rng.integers(30, 70))
    order = rng.permutation(n)

    def lists():
        rows, cols = [], []
        for r in range(n):
            if rng.random() < 0.25:
                c = rng.choice(n, int(rng.integers(0, n // 3)), replace=False)
            else:
                c = order[: int(rng.integers(0, n // 2 if rng.random() < 0.8
                                             else n))]
            rows.append(np.full(len(c), r))
            cols.append(np.sort(c))
        return np.concatenate(rows), np.concatenate(cols)

    def mags(m):
        if dtype == np.int32:
            return rng.integers(1, 10, m).astype(np.int32)
        return (rng.random(m) * 4 + 0.5).astype(np.float32)

    ar, ac = lists()
    br, bc = lists()
    if not transpose_b:         # B's lists are its columns
        br, bc = bc, br
    mr, mc, _ = _rand_mat(rng, n, True)
    return n, [(ar, ac, -mags(len(ar))), (br, bc, mags(len(br))),
               (mr, mc, np.ones(len(mr), dtype))]


def fuzz_matrices(seed, dtype=np.float32, device="cpu", make=fuzz_coo,
                  **kw):
    """n and the port matrices A, B and M of `fuzz_coo` (or of `make`,
    given `kw`)."""
    n, coo = make(seed, dtype, **kw)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    return n, [tgb.Matrix.from_coo(r, c, v, n, n, dtype=tdt, device=device)
               for r, c, v in coo]


I32 = 1 << 32


def _wrap(x):
    return ((int(x) + (1 << 31)) % I32) - (1 << 31)


def _np_ops(name, dtype):
    """(⊕, ⊗, identity) on NumPy scalars of `dtype`, as the kernel computes
    them: float32 rounded once per operation, int32 wrapping, min and max
    propagating NaN, logical ops and comparisons giving 1 or 0."""
    sr = _sr(name)
    ident = sr.identity(torch.float32 if dtype == np.float32
                        else torch.int32).item()
    f = np.float32 if dtype == np.float32 else (lambda x: _wrap(x))
    one, zero = f(1), f(0)
    muls = {
        "plus": lambda a, b: f(a + b) if dtype != np.float32 else a + b,
        "minus": lambda a, b: f(a - b) if dtype != np.float32 else a - b,
        "multiplies": lambda a, b: f(a * b) if dtype != np.float32 else a * b,
        "divides": lambda a, b: a / b,
        "greater": lambda a, b: one if a > b else zero,
        "less": lambda a, b: one if a < b else zero,
        "not_equal_to": lambda a, b: one if a != b else zero,
        "select_second": lambda a, b: b,
        "logical_and": lambda a, b: one if (a != 0 and b != 0) else zero,
    }
    adds = {
        "PlusMonoid": muls["plus"],
        "MinimumMonoid": lambda a, b: a if (a != a or a < b) else b,
        "MaximumMonoid": lambda a, b: a if (a != a or a > b) else b,
        "LogicalOrMonoid": lambda a, b: one if (a != 0 or b != 0) else zero,
        "MultipliesMonoid": muls["multiplies"],
        "GreaterMonoid": muls["greater"],
        "CustomLessMonoid": muls["less"],
        "NotEqualToMonoid": muls["not_equal_to"],
    }
    return adds[sr.add.name], muls[sr.mul.name], f(ident)


def _np_neutral(name, dtype):
    """⊕'s neutral element as a NumPy scalar of `dtype` (the kernel's)."""
    add = _sr(name).add.name
    if add not in ("MinimumMonoid", "MaximumMonoid"):
        return _np_ops(name, dtype)[2]
    if dtype == np.float32:
        big = np.float32(np.inf)
        return big if add == "MinimumMonoid" else -big
    return (1 << 31) - 1 if add == "MinimumMonoid" else -(1 << 31)


def _ids_bound(ops):
    """One more than the largest id of A's and B's lists (the ids a
    schedule built by the wrappers covers)."""
    _, _, a_ptr, a_ind, _, b_ptr, b_ind, _ = ops
    return max([int(ind[: int(ptr[-1])].max()) + 1
                for ptr, ind in ((a_ptr, a_ind), (b_ptr, b_ind))
                if int(ptr[-1])], default=0)


def _search_lanes(w0, w1, s, s0, s1, w):
    """The search route's lanes: lane -> [(walked pos, partner pos)] of the
    ids the lists share, in the lane's walk order (lanes stride the walked
    list; each lower_bound starts where the lane's last one ended)."""
    lanes = []
    for lane in range(32):
        hits, lo = [], s0
        for t in range(w0 + lane, w1, 32):
            key = w[t]
            lo = bisect.bisect_left(s, key, lo, s1)
            if lo == s1:
                break
            if s[lo] == key:
                hits.append((t, lo))
        lanes.append(hits)
    return lanes


def _bitmap_lanes(a_ind, a0, a1, b_ind, b0, b1):
    """The bitmap route's lanes: lane -> [(A pos, B pos)] of the hits, in
    the lane's walk order: lane l takes lb's l-th id before its first
    index that is a multiple of 4, then the ids at that index + 4l + 128r
    + q; each hit's A position from the staged bitmap and prefix counts,
    a0 + prefix[k >> 5] + popc(word k >> 5 below k)."""
    words, prefix = {}, {}
    for p in range(a0, a1):
        k = a_ind[p]
        words[k >> 5] = words.get(k >> 5, 0) | (1 << (k & 31))
        if p == a0 or a_ind[p - 1] >> 5 != k >> 5:
            prefix[k >> 5] = p - a0
    body = min((b0 + 3) & ~3, b1)
    lanes = []
    for lane in range(32):
        order = [b0 + lane] if b0 + lane < body else []
        for t in range(body + 4 * lane, b1, 128):
            order += [t + q for q in range(4) if t + q < b1]
        hits = []
        for t in order:
            k = b_ind[t]
            word = words.get(k >> 5, 0)
            if word >> (k & 31) & 1:
                below = bin(word & ((1 << (k & 31)) - 1)).count("1")
                hits.append((a0 + prefix[k >> 5] + below, t))
        lanes.append(hits)
    return lanes


def _replay(ops, add=None, mul=None, ident=None, neutral=None,
            minmax=False, trace=False, budget=isch.SMEM_BUDGET,
            all_bitmap=False):
    """T1's count and T2's values (when ⊕, ⊗, the identity and ⊕'s neutral
    are given; `minmax` when ⊕ is min or max, `trace` for the trace's
    rule) over the schedule the wrappers build (T2's, with a bitmap budget
    of `budget` bytes; `all_bitmap`: every edge on the bitmap route where
    it fits), the set of sides the search route walked (True: A's row) and
    the set of routes taken (True: the bitmap)."""
    sched = isch.build_intersect_schedule(ops[0], ops[1], ops[2], ops[5],
                                          _ids_bound(ops), True, budget,
                                          all_bitmap=all_bitmap)
    routes = sched.bitmap.tolist()
    mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val = [
        None if t is None else t.tolist() for t in ops]
    if a_val is not None and ident is not None:
        cast = type(ident)
        a_val = [cast(v) for v in a_val]
        b_val = [cast(v) for v in b_val]
    c, count, sides = [], 0, set()
    for i, j, bitmap in zip(mi, mj, routes):
        a0, a1, b0, b1 = a_ptr[i], a_ptr[i + 1], b_ptr[j], b_ptr[j + 1]
        if bitmap:
            lanes = _bitmap_lanes(a_ind, a0, a1, b_ind, b0, b1)
        else:
            walk_a = not (b1 - b0 < a1 - a0)
            sides.add(walk_a)
            if walk_a:
                lanes = _search_lanes(a0, a1, b_ind, b0, b1, a_ind)
            else:
                lanes = [[(s_, t) for t, s_ in hits] for hits in
                         _search_lanes(b0, b1, a_ind, a0, a1, b_ind)]
        hits = sum(len(h) for h in lanes)
        count += hits
        if ident is None:
            continue
        acc = [neutral] * 32
        for lane, lane_hits in enumerate(lanes):
            for ap, bp in lane_hits:
                acc[lane] = add(acc[lane], mul(a_val[ap], b_val[bp]))
        for off in (16, 8, 4, 2, 1):
            acc = [add(acc[x], acc[x ^ off]) for x in range(32)]
        la, lb = a1 - a0, b1 - b0
        miss = (hits < la if trace
                else hits < min(la, lb) or hits == 0)
        c.append(add(acc[0], ident) if minmax and miss else acc[0])
    return count, c, sides, set(routes)


# the folds over the intersection schedule, and the ordered ones
SEMIRING_DTYPES = [(name, dt) for name in mx.FOLD_SEMIRINGS
                   for dt in (np.float32, np.int32)
                   if not (name == "PlusDivides" and dt == np.int32)
                   and not mx.ordered(_sr(name))]
ORDERED_DTYPES = [(name, dt) for name in mx.FOLD_SEMIRINGS
                  for dt in (np.float32, np.int32) if mx.ordered(_sr(name))]


def replay_ordered(ops, name, dtype):
    """The ordered fold of csrc/masked_intersect.cu replayed in Python: for
    each mask edge, its walked list (B's only when strictly shorter) from
    the end, 32 lanes a round, each round's lanes folded by the shuffle
    tree (the lane at the larger offset on the left), the trees kept on a
    stack that merges two of one size (the later one on the left); the
    lanes left over pushed one by one; then lane 0's first lane folds the
    stack from its top; every float32 value read and result flushed to a
    zero of its sign where subnormal. Returns the values, a NumPy array of
    dtype."""
    add0, mul0, ident = _np_ops(name, dtype)
    tiny = np.finfo(np.float32).tiny

    def flush(x):
        if dtype == np.float32 and abs(x) < tiny:
            return np.float32(np.copysign(0.0, x))
        return x

    def add(x, y):
        return flush(add0(x, y))

    def mul(x, y):
        return flush(mul0(flush(x), flush(y)))

    mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val = [t.tolist()
                                                        for t in ops]
    cast = type(ident)
    a_val, b_val = [cast(v) for v in a_val], [cast(v) for v in b_val]
    out = []
    for i, j in zip(mi, mj):
        a0, a1, b0, b1 = a_ptr[i], a_ptr[i + 1], b_ptr[j], b_ptr[j + 1]
        walk_a = not (b1 - b0 < a1 - a0)
        w, w0, n = (a_ind, a0, a1 - a0) if walk_a else (b_ind, b0, b1 - b0)
        o, o0, o1 = (b_ind, b0, b1) if walk_a else (a_ind, a0, a1)

        def lane(t):
            key = w[w0 + t]
            p = bisect.bisect_left(o, key, o0, o1)
            if p == o1 or o[p] != key:
                return ident
            return (mul(a_val[w0 + t], b_val[p]) if walk_a
                    else mul(a_val[p], b_val[w0 + t]))

        if n == 0:
            out.append(ident)
            continue
        stack = []

        def push(v, size):
            stack.append((v, size))
            while len(stack) > 1 and stack[-1][1] == stack[-2][1]:
                (later, k), (earlier, _) = stack.pop(), stack.pop()
                stack.append((add(later, earlier), 2 * k))

        rest = n - 1
        for r in range(rest // 32):
            v = [lane(n - 1 - (32 * r + x)) for x in range(32)]
            d = 1
            while d < 32:
                v = [add(v[x + d], v[x]) if x % (2 * d) == 0 else v[x]
                     for x in range(32 - d)] + v[32 - d:]
                d *= 2
            push(v[0], 32)
        for x in range(rest % 32):
            push(lane(n - 1 - (32 * (rest // 32) + x)), 1)
        acc = lane(0)
        while stack:
            acc = add(acc, stack.pop()[0])
        out.append(acc)
    return np.array(out, dtype=dtype)


def replay_ops(ops, name, dtype, trace=False, budget=isch.SMEM_BUDGET,
               all_bitmap=False):
    """(count, values as a NumPy array of dtype, sides the search route
    walked, routes taken) of T1 and T2 on the operands `ops`
    (ops/spgemm.py `_operands` on CPU tensors), over the schedule of
    bitmap budget `budget` bytes (and `all_bitmap`)."""
    add, mul, ident = _np_ops(name, dtype)
    minmax = _sr(name).add.name in ("MinimumMonoid", "MaximumMonoid")
    with np.errstate(all="ignore"):
        count, c, sides, routes = _replay(ops, add, mul, ident,
                                          _np_neutral(name, dtype), minmax,
                                          trace, budget, all_bitmap)
    return count, np.array(c, dtype=dtype), sides, routes


# the schedules the replays walk, as (budget, all_bitmap): each edge on
# the route its cost picks; every edge on the bitmap route; every edge on
# the search route (no budget)
ROUTINGS = ((isch.SMEM_BUDGET, False), (isch.SMEM_BUDGET, True), (0, False))


def replay_both_routes(ops, name, dtype, trace=False):
    """[(count, values)] of `replay_ops` under each of ROUTINGS, checking
    that the second sends every edge down the bitmap route and the third
    every edge down the search route, on both sides."""
    out = []
    for budget, all_bitmap in ROUTINGS:
        count, got, sides, routes = replay_ops(ops, name, dtype, trace,
                                               budget, all_bitmap)
        if all_bitmap:
            assert routes == {True}
        elif not budget:
            assert routes == {False} and sides == {True, False}
        out.append((count, got))
    return out


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_replay_of_the_fold_equals_plain(name, dtype, transpose_b):
    """T2's walk and fold order, replayed, against the plain version; T1's
    count against the plain count and the wrapper (plain on the CPU)."""
    _, (A, B, M) = fuzz_matrices(5, dtype)
    ops = sp._operands(A, B, M, transpose_b)
    want = mx.masked_intersect_fold_plain(*ops, _sr(name))
    assert want.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    args = sp._count_args(ops)
    for count, got in replay_both_routes(ops, name, dtype):
        _close(got, want.numpy(), plus=name.startswith("Plus"))
        assert count == mx.masked_intersect_count_plain(*args)
        assert count == mx.masked_intersect_count(*args)


def test_replay_of_the_trace_equals_plain():
    T = tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                            device="cpu")
    ops = sp._diagonal_operands(T, T)
    want = sp.intersect_rows_reduce_plain(T, T, tgb.PlusMultipliesSemiring)
    for budget, all_bitmap in ROUTINGS:
        _, c, _, _ = replay_ops(ops, "PlusMultiplies", np.float32,
                                budget=budget, all_bitmap=all_bitmap)
        assert float(c.sum(dtype=np.float32)) == pytest.approx(
            float(want), rel=1e-5)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_replay_on_nested_lists_equals_plain(name, dtype, transpose_b):
    """As above, on `nested_coo`: walked lists matched in full, empty
    lists, negative products, so that the identity's rule decides min and
    max."""
    _, (A, B, M) = fuzz_matrices(2, dtype, make=nested_coo,
                                 transpose_b=transpose_b)
    ops = sp._operands(A, B, M, transpose_b)
    want = mx.masked_intersect_fold_plain(*ops, _sr(name))
    for _, got in replay_both_routes(ops, name, dtype):
        _close(got, want.numpy(), plus=name.startswith("Plus"))


@pytest.mark.parametrize("name", ["MaximumMultiplies", "MinimumPlus",
                                  "MinimumSelectSecond"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_replay_of_the_trace_rule_equals_plain(name, dtype):
    """The trace's rule (the identity joins where A's row holds an id B's
    lacks), replayed row by row against the plain version."""
    _, (A, B, _) = fuzz_matrices(3, dtype, make=nested_coo)
    ops = sp._diagonal_operands(A, B)
    want = mx.masked_intersect_fold_plain(*ops, _sr(name), trace=True)
    for _, got in replay_both_routes(ops, name, dtype, trace=True):
        np.testing.assert_array_equal(got, want.numpy())


def test_max_identity_joins_only_on_a_miss():
    """MaximumMultiplies, whose identity is 0: a max of negative products
    stays negative where the walked (shorter) list is matched in full, and
    is 0 where it holds an id the other lacks, or the lists share none."""
    # A's rows: 0 {1, 2}, 1 {1, 3}, 2 {}; B's rows (taken transposed):
    # 0 {1, 2, 3}, 1 {2}
    a = tgb.Matrix.from_coo(np.array([0, 0, 1, 1]), np.array([1, 2, 1, 3]),
                            np.array([-1.0, -2.0, -3.0, -4.0], np.float32),
                            4, 4, device="cpu")
    b = tgb.Matrix.from_coo(np.array([0, 0, 0, 1]), np.array([1, 2, 3, 2]),
                            np.array([1.0, 2.0, 3.0, 5.0], np.float32),
                            4, 4, device="cpu")
    m = tgb.Matrix.from_coo(np.array([0, 0, 1, 1, 2]),
                            np.array([0, 1, 0, 1, 0]),
                            np.ones(5, np.float32), 4, 4, device="cpu")
    c = sp.spgemm_masked(a, b, m, tgb.MaximumMultipliesSemiring,
                         transpose_b=True)
    # (0,0): {1,2} in full, max(-1, -4); (0,1): B's {2} in full, -10;
    # (1,0): {1,3} in full, max(-3, -12); (1,1): {2} misses, 0; (2,0): 0
    want = [-1.0, -10.0, -3.0, 0.0, 0.0]
    assert c.val[: c.nvals].tolist() == want
    ops = sp._operands(a, b, m, True)
    for budget, all_bitmap in ROUTINGS:   # the kernel's walk, either route
        _, got, _, _ = replay_ops(ops, "MaximumMultiplies", np.float32,
                                  budget=budget, all_bitmap=all_bitmap)
        assert got.tolist() == want


def _long_lists_coo(seed, dtype=np.float32, transpose_b=True):
    """n and the COO of A, B and M where A's rows and B's lists (its rows
    when transpose_b, else its columns) hold 70-200 ids
    (several 32-lane rounds of the ordered fold and a partial one), with
    values of both signs, half of B's ids shared with A's order."""
    rng = np.random.default_rng(1200 + seed)
    n = 256
    order = rng.permutation(n)

    def lists(k):
        rows, cols = [], []
        for r in range(k):
            m = int(rng.integers(70, 200))
            c = (order[:m] if rng.random() < 0.5
                 else rng.choice(n, m, replace=False))
            rows.append(np.full(m, r))
            cols.append(np.sort(c))
        return np.concatenate(rows), np.concatenate(cols)

    def vals(m):
        if dtype == np.int32:
            return rng.integers(-5, 6, m).astype(np.int32)
        return (rng.random(m) * 2.5 - 1.0).astype(np.float32)

    ar, ac = lists(12)
    br, bc = lists(12)
    if not transpose_b:         # B's lists are its columns
        br, bc = bc, br
    mr = rng.integers(0, 12, 60)
    mc = rng.integers(0, 12, 60)
    key = np.unique(mr * n + mc)
    mr, mc = key // n, key % n
    return n, [(ar, ac, vals(len(ar))), (br, bc, vals(len(br))),
               (mr, mc, np.ones(len(mr), dtype))]


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("make", ["fuzz", "nested", "long"])
@pytest.mark.parametrize("name,dtype", ORDERED_DTYPES)
def test_replay_of_the_ordered_fold_equals_plain(name, dtype, make,
                                                 transpose_b):
    """The ordered fold's rounds, shuffle trees and stack, replayed, equal
    the plain version (the JAX join's lanes through segops.segmented_scan)
    bitwise, on the fuzz lists (hub rows: both sides walked), the nested
    lists (walked lists matched in full, empty lists) and long lists
    (several rounds and a partial one)."""
    if make == "fuzz":
        _, (A, B, M) = fuzz_matrices(4, dtype)
    elif make == "nested":
        _, (A, B, M) = fuzz_matrices(3, dtype, make=nested_coo,
                                     transpose_b=transpose_b)
    else:
        _, (A, B, M) = fuzz_matrices(0, dtype, make=_long_lists_coo,
                                     transpose_b=transpose_b)
    ops = sp._operands(A, B, M, transpose_b)
    want = mx.masked_intersect_fold_plain(*ops, _sr(name)).numpy()
    with np.errstate(all="ignore"):
        got = replay_ordered(ops, name, dtype)
    assert got.tobytes() == want.tobytes()
    mi, mj, a_ptr, _, _, b_ptr, _, _ = ops
    len_a = (a_ptr[mi.long() + 1] - a_ptr[mi.long()])
    len_b = (b_ptr[mj.long() + 1] - b_ptr[mj.long()])
    assert bool((len_b < len_a).any()) and bool((len_b >= len_a).any())
    if make == "long":
        assert int(torch.minimum(len_a, len_b).max()) > 64
