"""The walk of T1 and T2 (csrc/masked_intersect.cu), replayed on the CPU.

The kernels walk each mask edge with one warp: the side choice (B's list
only when strictly shorter), the 32 lanes striding the walked list, each
lane's lower_bound starting where its last one ended, each lane's fold in
walk order from ⊕'s neutral element, a butterfly over offsets 16, 8, 4, 2,
1, then, for min and max, ⊕ the identity where the JAX join brings it in
(the masked mxm's rule, or the trace's).
`_replay` repeats that in Python with the kernel's arithmetic (float32
rounded once per operation, int32 wrapping, NaN-propagating min and max,
logical ops and comparisons giving 1 or 0) and must equal the plain
versions, which always expand A's side and search B's int64 keys, for every
semiring T2 folds on int32 and float32 values, on inputs whose hub rows make
the walk take both sides. This file imports no JAX: tests/test_torch_cuda.py
holds the kernels bitwise to the same replay on the card. Tolerances:
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


def _replay(ops, add=None, mul=None, ident=None, neutral=None,
            minmax=False, trace=False):
    """T1's count and T2's values (when ⊕, ⊗, the identity and ⊕'s neutral
    are given; `minmax` when ⊕ is min or max, `trace` for the trace's
    rule), and the set of sides walked (True: A's row)."""
    mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val = [
        None if t is None else t.tolist() for t in ops]
    if a_val is not None and ident is not None:
        cast = type(ident)
        a_val = [cast(v) for v in a_val]
        b_val = [cast(v) for v in b_val]
    c, count, sides = [], 0, set()
    for i, j in zip(mi, mj):
        a0, a1, b0, b1 = a_ptr[i], a_ptr[i + 1], b_ptr[j], b_ptr[j + 1]
        walk_a = not (b1 - b0 < a1 - a0)
        sides.add(walk_a)
        w, s = (a_ind, b_ind) if walk_a else (b_ind, a_ind)
        w0, w1 = (a0, a1) if walk_a else (b0, b1)
        s0, s1 = (b0, b1) if walk_a else (a0, a1)
        lanes = [neutral] * 32
        hits = 0
        for lane in range(32):
            lo = s0
            for t in range(w0 + lane, w1, 32):
                key = w[t]
                lo = bisect.bisect_left(s, key, lo, s1)
                if lo == s1:
                    break
                if s[lo] == key:
                    count += 1
                    hits += 1
                    if ident is not None:
                        ap, bp = (t, lo) if walk_a else (lo, t)
                        lanes[lane] = add(lanes[lane],
                                          mul(a_val[ap], b_val[bp]))
        if ident is not None:
            for off in (16, 8, 4, 2, 1):
                lanes = [add(lanes[x], lanes[x ^ off]) for x in range(32)]
            la, lb = a1 - a0, b1 - b0
            miss = (hits < la if trace
                    else hits < min(la, lb) or hits == 0)
            c.append(add(lanes[0], ident) if minmax and miss else lanes[0])
    return count, c, sides


SEMIRING_DTYPES = [(name, dt) for name in mx.FOLD_SEMIRINGS
                   for dt in (np.float32, np.int32)
                   if not (name == "PlusDivides" and dt == np.int32)]


def replay_ops(ops, name, dtype, trace=False):
    """(count, values as a NumPy array of dtype, sides walked) of T1 and T2
    on the operands `ops` (ops/spgemm.py `_operands` on CPU tensors)."""
    add, mul, ident = _np_ops(name, dtype)
    minmax = _sr(name).add.name in ("MinimumMonoid", "MaximumMonoid")
    with np.errstate(all="ignore"):
        count, c, sides = _replay(ops, add, mul, ident,
                                  _np_neutral(name, dtype), minmax, trace)
    return count, np.array(c, dtype=dtype), sides


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_replay_of_the_fold_equals_plain(name, dtype, transpose_b):
    """T2's walk and fold order, replayed, against the plain version; T1's
    count against the plain count and the wrapper (plain on the CPU)."""
    _, (A, B, M) = fuzz_matrices(5, dtype)
    ops = sp._operands(A, B, M, transpose_b)
    count, got, sides = replay_ops(ops, name, dtype)
    assert sides == {True, False}
    want = mx.masked_intersect_fold_plain(*ops, _sr(name))
    assert want.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    _close(got, want.numpy(), plus=name.startswith("Plus"))
    args = sp._count_args(ops)
    assert count == mx.masked_intersect_count_plain(*args)
    assert count == mx.masked_intersect_count(*args)


def test_replay_of_the_trace_equals_plain():
    T = tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                            device="cpu")
    ops = sp._diagonal_operands(T, T)
    _, c, _ = replay_ops(ops, "PlusMultiplies", np.float32)
    want = sp.intersect_rows_reduce_plain(T, T, tgb.PlusMultipliesSemiring)
    assert float(c.sum(dtype=np.float32)) == pytest.approx(float(want),
                                                           rel=1e-5)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name,dtype", SEMIRING_DTYPES)
def test_replay_on_nested_lists_equals_plain(name, dtype, transpose_b):
    """As above, on `nested_coo`: walked lists matched in full, empty
    lists, negative products, so that the identity's rule decides min and
    max."""
    _, (A, B, M) = fuzz_matrices(2, dtype, make=nested_coo,
                                 transpose_b=transpose_b)
    ops = sp._operands(A, B, M, transpose_b)
    _, got, sides = replay_ops(ops, name, dtype)
    assert sides == {True, False}
    want = mx.masked_intersect_fold_plain(*ops, _sr(name))
    _close(got, want.numpy(), plus=name.startswith("Plus"))


@pytest.mark.parametrize("name", ["MaximumMultiplies", "MinimumPlus",
                                  "MinimumSelectSecond"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_replay_of_the_trace_rule_equals_plain(name, dtype):
    """The trace's rule (the identity joins where A's row holds an id B's
    lacks), replayed row by row against the plain version."""
    _, (A, B, _) = fuzz_matrices(3, dtype, make=nested_coo)
    ops = sp._diagonal_operands(A, B)
    _, got, sides = replay_ops(ops, name, dtype, trace=True)
    assert sides == {True, False}
    want = mx.masked_intersect_fold_plain(*ops, _sr(name), trace=True)
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
    assert c.val[: c.nvals].tolist() == [-1.0, -10.0, -3.0, 0.0, 0.0]
