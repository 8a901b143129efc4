"""The masked SpGEMM, its structural count and the trace on the CPU
(graphblast_tpu_torch ops/spgemm.py over ops/kernels/masked_intersect.py).

The same COO, made with NumPy from a seed, goes to both packages; the JAX
side runs as its own tests run it on the CPU (the chunked sort joins of
graphblast_tpu/ops/spgemm.py). The inputs of the fuzz twins have hub rows,
so that the kernels' walk takes both sides (tests/test_torch_intersect_
replay.py replays it). Tolerances: counts, min, max and or exact; Plus on
float32 within rtol 1e-5 and 1e-5·max|c| absolute (sums of signed terms
cancel, so a sum near 0 has no relative bound).
"""
import os

import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops.spgemm import spgemm_masked as jspgemm_masked
from graphblast_tpu.ops.spgemm import (spgemm_masked_count as
                                       jspgemm_masked_count)
from graphblast_tpu_torch.dimension import DimensionException
from graphblast_tpu_torch.ops import spgemm as sp
from graphblast_tpu_torch.ops.kernels import masked_intersect as mx
from test_torch_intersect_replay import (_close, _np_neutral, _np_ops,
                                         _rand_mat, _replay, fuzz_coo,
                                         nested_coo)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
FUZZ_SEMIRINGS = ["PlusMultiplies", "MinimumPlus", "LogicalOrAnd",
                  "MaximumMultiplies", "PlusMinus"]


def _sr(name, pkg=tgb):
    return getattr(pkg.semiring, f"{name}Semiring")


def _both(rows, cols, vals, n, ncols=None, dtype=np.float32):
    """The same COO as a JAX Matrix and a port Matrix on the CPU."""
    ncols = n if ncols is None else ncols
    vals = np.asarray(vals, dtype)
    J = jgb.Matrix.from_coo(rows, cols, vals, n, ncols, dtype=vals.dtype)
    T = tgb.Matrix.from_coo(rows, cols, vals, n, ncols,
                            dtype=torch.from_numpy(vals[:0]).dtype,
                            device="cpu")
    return J, T


def _chesapeake():
    J = jgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"))
    T = tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                            device="cpu")
    return J, T


def _fuzz_pair(seed):
    """n and (JAX, port) twins of A, B and M from `fuzz_coo`."""
    n, coo = fuzz_coo(seed)
    return n, [_both(r, c, v, n) for r, c, v in coo]


def _dense(C):
    """A port Matrix as a dense NumPy array (its stored entries)."""
    r, c, v = C.extract_tuples()
    out = np.zeros(C.shape, v.dtype)
    out[r, c] = v
    return out


# -- twins of test_catalog.py ------------------------------------------------

def test_trace_mxm_transpose():
    J, T = _chesapeake()
    Ad = J.to_dense()
    want = float(np.trace(Ad @ Ad.T))
    got = tgb.trace_mxm_transpose(T, T, tgb.PlusMultipliesSemiring)
    jgot = float(jgb.trace_mxm_transpose(J, J, jgb.PlusMultipliesSemiring))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(got) == pytest.approx(jgot, rel=1e-5)
    assert float(got) == pytest.approx(float(sp.intersect_rows_reduce_plain(
        T, T, tgb.PlusMultipliesSemiring)), rel=1e-5)


def test_masked_mxm_matches_dense():
    J, T = _chesapeake()
    Ad = J.to_dense()
    C = tgb.mxm(T, T, tgb.PlusMultipliesSemiring, mask=T)
    assert C.shape == T.shape and C.nvals == T.nvals
    want = (Ad @ Ad) * (Ad != 0)
    _close(_dense(C), want, plus=True)
    jC = jgb.mxm(J, J, jgb.PlusMultipliesSemiring, mask=J)
    _close(_dense(C), jC.to_dense(), plus=True)


@pytest.mark.parametrize("transpose_b", [False, True])
def test_masked_mxm_both_orientations(transpose_b):
    """test_masked_mxm_multichunk's goldens: A·A and A·Aᵀ on A's mask."""
    J, T = _chesapeake()
    Ad = J.to_dense()
    want = (Ad @ (Ad.T if transpose_b else Ad)) * (Ad != 0)
    C = sp.spgemm_masked(T, T, T, tgb.PlusMultipliesSemiring,
                         transpose_b=transpose_b)
    _close(_dense(C), want, plus=True)
    jC = jspgemm_masked(J, J, J, jgb.PlusMultipliesSemiring,
                        transpose_b=transpose_b)
    _close(_dense(C), jC.to_dense(), plus=True)


def test_masked_mxm_minplus():
    J, T = _chesapeake()
    Ad = J.to_dense()
    big = np.float32(3.4028235e38)
    W = np.where(Ad != 0, Ad, big)
    want_full = np.minimum.reduce(
        (W[:, :, None].astype(np.float64) + W[None, :, :]), axis=1)
    got = _dense(sp.spgemm_masked(T, T, T, tgb.MinimumPlusSemiring))
    cmp = (Ad != 0) & (want_full < big / 2)
    # float32 rounding is monotone: the min of the rounded sums is the
    # rounded min
    np.testing.assert_array_equal(got[cmp],
                                  want_full[cmp].astype(np.float32))
    # no product: the identity, FLT_MAX, as the JAX package stores it
    jgot = jspgemm_masked(J, J, J, jgb.MinimumPlusSemiring).to_dense()
    np.testing.assert_array_equal(got, jgot)


def test_masked_mxm_minside_noncommutative():
    """⊗ keeps A-then-B order whichever list the walk takes: PlusMinus on
    a value-perturbed copy of A (test_catalog.py:463)."""
    J, T = _chesapeake()
    rng = np.random.default_rng(7)
    r, c, _ = T.extract_tuples()
    bv = rng.uniform(1.0, 2.0, T.nvals).astype(np.float32)
    JB, TB = _both(r, c, bv, T.nrows)
    Ad, Bd = J.to_dense(), JB.to_dense()
    inter = (Ad != 0)[:, :, None] * (Bd != 0)[None, :, :]
    want = ((Ad[:, :, None] - Bd[None, :, :]) * inter).sum(axis=1) * (Ad != 0)
    got = _dense(sp.spgemm_masked(T, TB, T, tgb.PlusMinusSemiring))
    _close(got, want, plus=True)
    _close(got, jspgemm_masked(J, JB, J, jgb.PlusMinusSemiring).to_dense(),
           plus=True)
    ops = sp._operands(T, TB, T, False)
    assert len(_replay(ops)[2]) == 2      # both sides are walked here


# -- twins of test_fuzz.py ---------------------------------------------------

@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("name", FUZZ_SEMIRINGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_masked_spgemm(seed, name, transpose_b):
    """Against the brute-force dense evaluation over stored entries and the
    JAX spgemm_masked, with hub rows so that the walk switches sides."""
    n, ((JA, A), (JB, B), (JM, M)) = _fuzz_pair(seed)
    Ad, Bd, Md = JA.to_dense(), JB.to_dense(), JM.to_dense()
    semiring = _sr(name)
    add, mul, ident = _np_ops(name, np.float32)
    Bside = Bd.T if transpose_b else Bd
    mi, mj = np.nonzero(Md)
    want = np.zeros((n, n), np.float32)
    for i, j in zip(mi, mj):
        acc = ident
        for k in range(n):
            if Ad[i, k] != 0 and Bside[k, j] != 0:
                acc = add(acc, mul(np.float32(Ad[i, k]),
                                   np.float32(Bside[k, j])))
        want[i, j] = acc
    got = _dense(sp.spgemm_masked(A, B, M, semiring,
                                  transpose_b=transpose_b))
    plus = name.startswith("Plus")
    _close(got[mi, mj], want[mi, mj], plus)
    jgot = jspgemm_masked(JA, JB, JM, _sr(name, jgb),
                          transpose_b=transpose_b).to_dense()
    _close(got[mi, mj], jgot[mi, mj], plus)
    ops = sp._operands(A, B, M, transpose_b)
    assert len(_replay(ops)[2]) == 2


def _rule_golden(coo, name, dtype, transpose_b, trace=False):
    """The JAX join's values over COO (A, B, M), in Python: ⊕ of the
    products over the ids both lists hold, from ⊕'s neutral, then, for
    min and max, ⊕ the identity where the walked (shorter) list holds an
    id the other lacks or the lists share none (`trace`: where A's row
    holds an id B's lacks); one value a mask entry, in M's COO order."""
    (ar, ac, av), (br, bc, bv), (mr, mc, _) = coo
    add, mul, ident = _np_ops(name, dtype)
    neutral = _np_neutral(name, dtype)
    cast = type(ident)
    rows_a, lists_b = {}, {}
    for r, c, v in zip(ar, ac, av):
        rows_a.setdefault(int(r), {})[int(c)] = cast(v)
    for r, c, v in zip(br, bc, bv):
        key, k = (int(r), int(c)) if transpose_b else (int(c), int(r))
        lists_b.setdefault(key, {})[k] = cast(v)
    out = []
    with np.errstate(all="ignore"):
        for i, j in zip(mr, mc):
            la, lb = rows_a.get(int(i), {}), lists_b.get(int(j), {})
            both = sorted(set(la) & set(lb))
            acc = neutral
            for k in both:
                acc = add(acc, mul(la[k], lb[k]))
            miss = (len(both) < len(la) if trace else
                    len(both) < min(len(la), len(lb)) or not both)
            if miss and _sr(name).add.name in ("MinimumMonoid",
                                               "MaximumMonoid"):
                acc = add(acc, ident)
            out.append(acc)
    return np.array(out, dtype=dtype)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", FUZZ_SEMIRINGS)
def test_fuzz_masked_spgemm_nested_negative(name, dtype, transpose_b):
    """The five fuzz semirings on nested lists (the walked list often
    matched in full) with negative products, int32 and float32: against
    the JAX spgemm_masked and the join's rule in Python. MaximumMultiplies'
    identity 0 must join only where a walked id has no partner."""
    n, coo = nested_coo(0, dtype, transpose_b)
    (JA, A), (JB, B), (JM, M) = [_both(r, c, v, n, dtype=dtype)
                                 for r, c, v in coo]
    mr, mc, _ = M.extract_tuples()
    want = _rule_golden((coo[0], coo[1], (mr, mc, None)), name, dtype,
                        transpose_b)
    got = _dense(sp.spgemm_masked(A, B, M, _sr(name),
                                  transpose_b=transpose_b))[mr, mc]
    plus = name.startswith("Plus")
    _close(got, want, plus)
    jgot = jspgemm_masked(JA, JB, JM, _sr(name, jgb),
                          transpose_b=transpose_b).to_dense()[mr, mc]
    _close(got, jgot, plus)
    assert len(_replay(sp._operands(A, B, M, transpose_b))[2]) == 2
    if name == "MaximumMultiplies":
        assert (got < 0).any() and (got == 0).any()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", FUZZ_SEMIRINGS)
def test_trace_nested_negative(name, dtype):
    """trace_mxm_transpose(A, B) on nested rows with negative products,
    against the JAX package: the identity joins where A's row holds an id
    B's lacks, and for A's padded slots."""
    n, coo = nested_coo(1, dtype)
    (JA, A), (JB, B) = [_both(r, c, v, n, dtype=dtype) for r, c, v in
                        coo[:2]]
    got = tgb.trace_mxm_transpose(A, B, _sr(name))
    jgot = np.asarray(jgb.trace_mxm_transpose(JA, JB, _sr(name, jgb)))
    assert got.dtype == A.val.dtype and got.dim() == 0
    _close(got.numpy(), jgot, name.startswith("Plus"))
    assert torch.equal(got, sp.intersect_rows_reduce_plain(A, B, _sr(name)))


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_masked_count(seed, transpose_b):
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(30, 70))
    mats = []
    for hubs in (True, False, True):
        rows, cols, _ = _rand_mat(rng, n, hubs)
        mats.append(_both(rows, cols, np.ones(len(rows)), n))
    (JA, A), (JB, B), (JM, M) = mats
    Ad, Bd, Md = (X.to_dense() != 0 for X in (JA, JB, JM))
    Bside = Bd.T if transpose_b else Bd
    mi, mj = np.nonzero(Md)
    want = int(sum((Ad[i] & Bside[:, j]).sum() for i, j in zip(mi, mj)))
    assert sp.spgemm_masked_count(A, B, M, transpose_b=transpose_b) == want
    assert sp.spgemm_masked_count_plain(A, B, M,
                                        transpose_b=transpose_b) == want
    assert jspgemm_masked_count(JA, JB, JM, transpose_b=transpose_b) == want


def test_plain_version_chunked(monkeypatch):
    """The plain versions' expansion cut into many chunks gives the same
    values and count as one chunk."""
    n, ((_, A), (_, B), (_, M)) = _fuzz_pair(3)
    ops = sp._operands(A, B, M, True)
    one = mx.masked_intersect_fold_plain(*ops, tgb.MinimumPlusSemiring)
    count = mx.masked_intersect_count_plain(*sp._count_args(ops))
    monkeypatch.setattr(mx, "PLAIN_CHUNK_LANES", 7)
    assert torch.equal(
        mx.masked_intersect_fold_plain(*ops, tgb.MinimumPlusSemiring), one)
    assert mx.masked_intersect_count_plain(*sp._count_args(ops)) == count


# -- the operations around the walk ------------------------------------------

def test_tril_and_extract_tuples_match_jax():
    J, T = _chesapeake()
    jr, jc, jv = J.extract_tuples()
    r, c, v = T.extract_tuples()
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    L, JL = tgb.tril(T), jgb.tril(J)
    assert L.col_ptr is not None and not L.symmetric
    np.testing.assert_array_equal(_dense(L), JL.to_dense())
    np.testing.assert_array_equal(_dense(L), np.tril(J.to_dense(), -1))


def test_mxm_refusals():
    _, T = _chesapeake()
    S = tgb.PlusMultipliesSemiring
    # without a mask, mxm is the unmasked SpGEMM (here its dense route)
    St = T.to_scipy()
    np.testing.assert_array_equal(tgb.mxm(T, T, S).to_dense(),
                                  (St @ St).toarray())
    rows, cols = np.array([0, 1]), np.array([1, 2])
    _, R = _both(rows, cols, np.ones(2), 3, ncols=5)      # 3x5
    with pytest.raises(DimensionException):
        tgb.mxm(T, R, S, mask=T)
    with pytest.raises(DimensionException):
        tgb.mxm(R, R, S, mask=R)                          # inner 5 != 3
    with pytest.raises(DimensionException):               # mask 3x5 != 3x3
        sp.spgemm_masked(R, R, R, S, transpose_b=True)
    # GreaterPlus folds in the JAX join's order: equal to JAX's, bitwise
    J, _ = _chesapeake()
    got = _dense(tgb.mxm(T, T, tgb.semiring.GreaterPlusSemiring, mask=T))
    want = np.asarray(jspgemm_masked(J, J, J,
                                     jgb.semiring.GreaterPlusSemiring)
                      .to_dense())
    np.testing.assert_array_equal(got, want)


def test_duplicate_ids_are_refused():
    """The walk needs sorted lists without duplicates; from_coo keeps a
    duplicate entry, and the check refuses it once per Matrix."""
    rows, cols = np.array([0, 0, 1, 1]), np.array([1, 1, 0, 2])
    D = tgb.Matrix.from_coo(rows, cols, np.ones(4, np.float32), 3, 3,
                            device="cpu")
    with pytest.raises(ValueError, match="no duplicate"):
        sp.spgemm_masked_count(D, D, D, transpose_b=True)
    _, T = _chesapeake()
    sp.spgemm_masked_count(T, T, T, transpose_b=True)
    assert T._plans["csr/sorted"] and "csc/sorted" not in T._plans
    sp.spgemm_masked_count(T, T, T, transpose_b=False)
    assert T._plans["csc/sorted"]
