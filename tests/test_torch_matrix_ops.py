"""The port's Matrix container and the matrix half of its operations
surface against the JAX package (twins of tests/test_extract.py,
tests/test_matrix_assign.py and the Matrix tests of tests/test_catalog.py
and tests/test_ops.py).

The same seeded NumPy triplets build a JAX Matrix and a port Matrix on the
CPU. Each result is held to the JAX result leaf by leaf (pointers, ids and
padding exactly; values exactly where each is one op, 1e-6 relative where
a float op's rounding may differ), with its shape, nvals, format and
symmetric flag; the row reduce exactly for every monoid but the float sum
(within the JAX sum's own rounding).
"""
import os

import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu import operations as jops
from graphblast_tpu_torch.dimension import DimensionException

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")


def _pair(rows, cols, vals, nr, nc, fmt="CSRCSC"):
    return (jgb.Matrix.from_coo(rows, cols, vals, nr, nc,
                                fmt=getattr(jgb.SparseFormat, fmt)),
            tgb.Matrix.from_coo(rows, cols, vals, nr, nc,
                                fmt=getattr(tgb.SparseFormat, fmt),
                                device="cpu"))


def _mat(rng, nr, nc, m, fmt="CSRCSC"):
    flat = rng.choice(nr * nc, size=m, replace=False)
    vals = rng.standard_normal(m).astype(np.float32)
    return _pair(flat // nc, flat % nc, vals, nr, nc, fmt)


def _same(J, T, rtol=0.0):
    """Every leaf, the counts, the format and the symmetric flag."""
    assert (T.nrows, T.ncols, T.nvals) == (J.nrows, J.ncols, J.nvals)
    assert T.format.name == J.format.name and T.symmetric == J.symmetric
    for leaf in tgb.matrix.LEAVES:
        a, b = getattr(J, leaf), getattr(T, leaf)
        assert (a is None) == (b is None), leaf
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, leaf
        if leaf.endswith("val"):
            assert b.dtype == a.dtype, leaf
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=leaf)
        else:
            np.testing.assert_array_equal(b, a, err_msg=leaf)


@pytest.fixture(scope="module")
def chesapeake():
    return (jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False),
            tgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False, device="cpu"))


# ------------------------------------------------------------ the container
def test_matrix_dup_clear_fill_and_dense(chesapeake):
    """dup, clear (no entries, same capacity and format), fill (every value
    slot), to_dense, to_scipy, check, has_csr/has_csc: equal to JAX's."""
    J, T = chesapeake
    _same(J.dup(), T.dup())
    _same(J.clear(), T.clear())
    _same(J.fill(2.5), T.fill(2.5))
    np.testing.assert_array_equal(T.to_dense(), np.asarray(J.to_dense()))
    assert (T.to_scipy() != J.to_scipy()).nnz == 0
    assert T.check() and T.has_csr() and T.has_csc()
    assert T.fill(2.5).host_csr()[2].max() == 2.5


@pytest.mark.parametrize("fmt", ["CSRONLY", "CSCONLY", "CSRCSC"])
@pytest.mark.parametrize("graph", ["chesapeake", "directed"])
def test_matrix_set_storage(chesapeake, fmt, graph):
    """Narrowing keeps one orientation's tensors; widening a symmetric
    Matrix aliases its CSR, an asymmetric one is rebuilt: JAX's leaves and
    format each way (a CSC-only asymmetric Matrix has no JAX widening; the
    port rebuilds it from its CSC)."""
    if graph == "chesapeake":
        J, T = chesapeake
    else:
        J, T = _mat(np.random.default_rng(2), 30, 30, 120)
    Jn = J.set_storage(getattr(jgb.SparseFormat, fmt))
    Tn = T.set_storage(getattr(tgb.SparseFormat, fmt))
    _same(Jn, Tn)
    assert Tn.has_csr() == Jn.has_csr() and Tn.has_csc() == Jn.has_csc()
    if fmt == "CSRONLY":
        _same(Jn.set_storage(jgb.SparseFormat.CSRCSC),
              Tn.set_storage(tgb.SparseFormat.CSRCSC))
    if fmt == "CSCONLY":
        W = Tn.set_storage(tgb.SparseFormat.CSRCSC)
        np.testing.assert_array_equal(W.to_dense(), T.to_dense())


@pytest.mark.parametrize("build_csc", [True, False])
def test_from_device_csr_matches_jax(build_csc):
    """from_device_csr from CSR tensors: JAX's CSR leaves, and the CSC
    equal to from_coo's (the port's sort is stable; JAX's is not, so its
    CSC is held by its dense image)."""
    rng = np.random.default_rng(1234)
    n, m = 300, 2000
    rows = np.sort(rng.integers(0, n, m))
    cols = rng.integers(0, n, m)
    _, keep = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    J, T = _pair(rows, cols, vals, n, n)
    JB = jgb.Matrix.from_device_csr(J.row_ptr, J.col_ind, J.val, n, n,
                                    nvals=J.nvals, build_csc=build_csc)
    TB = tgb.Matrix.from_device_csr(T.row_ptr, T.col_ind[: T.nvals + 5],
                                    T.val, n, n, build_csc=build_csc)
    assert TB.format.name == JB.format.name and not TB.symmetric
    for leaf in tgb.matrix.LEAVES[:4]:
        np.testing.assert_array_equal(getattr(TB, leaf).numpy(),
                                      np.asarray(getattr(JB, leaf)))
    np.testing.assert_array_equal(TB.to_dense(), np.asarray(JB.to_dense()))
    if build_csc:
        for leaf in tgb.matrix.LEAVES[4:]:
            np.testing.assert_array_equal(getattr(TB, leaf).numpy(),
                                          getattr(T, leaf).numpy())
    else:
        assert TB.col_ptr is None


@pytest.mark.parametrize("fmt", ["CSRCSC", "CSRONLY", "CSCONLY"])
@pytest.mark.parametrize("kind", ["directed", "symmetric", "duplicates",
                                  "empty"])
def test_from_device_coo_equals_from_coo(fmt, kind):
    """from_device_coo builds from tensors exactly what the JAX package's
    from_coo builds on the host: every leaf, the format and the symmetric
    flag, duplicate triplets kept in order, on unsorted input; and the
    port's from_coo, which copies the triplets over and calls it, keeps
    host copies equal to the JAX Matrix's."""
    rng = np.random.default_rng(len(kind))
    n = 40
    if kind == "empty":
        r = c = np.zeros(0, np.int64)
    else:
        r, c = rng.integers(0, n, 300), rng.integers(0, n, 300)
        if kind == "symmetric":
            r, c = np.concatenate([r, c]), np.concatenate([c, r])
            key = np.unique(r * n + c)
            r, c = key // n, key % n
            perm = rng.permutation(len(r))
            r, c = r[perm], c[perm]
        elif kind != "duplicates":
            key = np.unique(r * n + c)
            r, c = key // n, key % n
    v = (np.ones(len(r)) if kind == "symmetric"
         else rng.standard_normal(len(r))).astype(np.float32)
    f = getattr(tgb.SparseFormat, fmt)
    J = jgb.Matrix.from_coo(r, c, v, n, n, fmt=getattr(jgb.SparseFormat,
                                                        fmt))
    D = tgb.Matrix.from_device_coo(torch.from_numpy(r), torch.from_numpy(c),
                                   torch.from_numpy(v), n, n, fmt=f)
    _same(J, D)
    H = tgb.Matrix.from_coo(r, c, v, n, n, fmt=f, device="cpu")
    _same(J, H)
    for side in ("csr", "csc"):
        want = getattr(J, f"_host_{side}", None)
        got = getattr(H, f"host_{side}")()
        assert (want is None) == (got is None), side
        for a, b in zip(want or (), got or ()):
            np.testing.assert_array_equal(b, np.asarray(a), side)


def test_from_dense_matches_jax():
    rng = np.random.default_rng(9)
    a = np.where(rng.random((7, 5)) < 0.4, rng.standard_normal((7, 5)), 0)
    for arr in (a.astype(np.float32), (a * 4).astype(np.int32)):
        _same(jgb.Matrix.from_dense(arr),
              tgb.Matrix.from_dense(arr, device="cpu"))
        _same(jgb.Matrix.from_dense(arr, fmt=jgb.SparseFormat.CSRONLY),
              tgb.Matrix.from_dense(torch.from_numpy(arr),
                                    fmt=tgb.SparseFormat.CSRONLY,
                                    device="cpu"))


# ------------------------------------------------------------ apply_matrix
@pytest.mark.parametrize("backend", ["device", "cpu"])
def test_apply_matrix_matches_jax(chesapeake, backend):
    """fn over the stored values, the padded slots left as they are: equal
    to JAX's on both of its backends (host functor or traced)."""
    J, T = chesapeake
    fn = lambda v: v * 2.0 + 1.0  # noqa: E731
    jd = jgb.Descriptor(backend="cpu" if backend == "cpu" else "tpu")
    _same(jops.apply_matrix(J, fn, jd),
          tgb.apply_matrix(T, fn, tgb.Descriptor(backend=backend)))
    state = {"calls": 0}

    def stateful(x):
        state["calls"] += 1
        return x + state["calls"] % 2

    out = tgb.apply_matrix(T, stateful, tgb.Descriptor(backend="cpu"))
    assert state["calls"] >= T.nvals and out.nvals == T.nvals


# ------------------------------------------------------------ extract
def test_extract_matrix_matches_jax():
    """Submatrices with repeated row and column ids, GrB_ALL on either
    side, a mask, and an empty mask (tests/test_extract.py's cases):
    equal leaves."""
    rng = np.random.default_rng(77)
    J, T = _mat(rng, 12, 9, 40)
    for ri, ci in (([3, 0, 7, 7], [8, 1, 1, 5]), (None, [5, 0]),
                   ([2, 2], None), (None, None)):
        _same(jgb.extract_matrix(J, ri, ci), tgb.extract_matrix(T, ri, ci))
    JM, TM = _pair([0, 1, 4], [2, 3, 3], np.ones(3), 5, 5)
    _same(jgb.extract_matrix(J, np.arange(5), np.arange(5), mask=JM),
          tgb.extract_matrix(T, np.arange(5), np.arange(5), mask=TM))
    J0, T0 = _pair([], [], [], 3, 3)
    C = tgb.extract_matrix(T, [0, 1, 2], [0, 1, 2], mask=T0)
    _same(jgb.extract_matrix(J, [0, 1, 2], [0, 1, 2], mask=J0), C)
    assert C.nvals == 0
    with pytest.raises(DimensionException):
        tgb.extract_matrix(T, [0, 12], None)
    with pytest.raises(DimensionException):
        tgb.extract_matrix(T, [0, 1], [0], mask=T0)


def test_extract_col_matches_jax():
    """A column's rows picked, all rows, with a mask and an accumulator
    into w; the bound checks. Exact."""
    rng = np.random.default_rng(78)
    J, T = _mat(rng, 12, 9, 40)
    for rows in ([11, 0, 3], None):
        np.testing.assert_array_equal(
            tgb.extract_col(T, rows, 4).to_numpy(),
            np.asarray(jgb.extract_col(J, rows, 4).to_numpy()))
    m = np.array([1, 0, 1], np.float32)
    w = np.array([5, 6, 7], np.float32)
    jy = jgb.extract_col(J, [11, 0, 3], 4, mask=jgb.Vector.dense_from(m),
                         accum=jgb.Plus, w=jgb.Vector.dense_from(w))
    ty = tgb.extract_col(T, [11, 0, 3], 4,
                         mask=tgb.Vector.dense_from(m, device="cpu"),
                         accum=tgb.Plus,
                         w=tgb.Vector.dense_from(w, device="cpu"))
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))
    with pytest.raises(DimensionException):
        tgb.extract_col(T, [0], 9)
    with pytest.raises(ValueError, match="CSC"):
        tgb.extract_col(T.set_storage(tgb.SparseFormat.CSRONLY), [0], 1)


# ------------------------------------------------------------ assign family
@pytest.mark.parametrize("accum", [None, "Plus", "Minimum"])
@pytest.mark.parametrize("masked", [False, True])
def test_assign_matrix_matches_jax(accum, masked):
    """C[ri, ci] ⊕?= mask .* A, overwriting or combining where C has an
    entry, C's other entries kept (tests/test_matrix_assign.py's case, with
    a mask and each accumulator)."""
    rng = np.random.default_rng(5)
    JC, TC = _mat(rng, 8, 8, 20)
    JA, TA = _mat(rng, 3, 2, 5)
    JM, TM = _pair([0, 2, 1], [1, 0, 1], np.ones(3), 3, 2)
    ri, ci = np.asarray([1, 4, 6]), np.asarray([0, 7])
    kw_j = dict(accum=getattr(jgb, accum) if accum else None,
                mask=JM if masked else None)
    kw_t = dict(accum=getattr(tgb, accum) if accum else None,
                mask=TM if masked else None)
    _same(jgb.assign_matrix(JC, JA, ri, ci, **kw_j),
          tgb.assign_matrix(TC, TA, ri, ci, **kw_t))


def test_assign_matrix_scalar_col_row_match_jax():
    rng = np.random.default_rng(7)
    JC, TC = _mat(rng, 6, 6, 12)
    JM, TM = _pair([0, 1], [1, 0], np.ones(2), 2, 2)
    _same(jgb.assign_matrix_scalar(JC, 9.0, [2, 5], [3, 0], mask=JM),
          tgb.assign_matrix_scalar(TC, 9.0, [2, 5], [3, 0], mask=TM))
    _same(jgb.assign_matrix_scalar(JC, 4.0, None, [1], accum=jgb.Plus),
          tgb.assign_matrix_scalar(TC, 4.0, None, [1], accum=tgb.Plus))
    u = np.asarray([10.0, 20.0], np.float32)
    m = np.asarray([0.0, 1.0], np.float32)
    for scmp in (False, True):
        jd = jgb.Descriptor(mask_scmp=scmp)
        td = tgb.Descriptor(mask_scmp=scmp)
        _same(jgb.assign_matrix_col(JC, jgb.Vector.dense_from(u), [4, 1], 2,
                                    mask=jgb.Vector.dense_from(m), desc=jd),
              tgb.assign_matrix_col(
                  TC, tgb.Vector.dense_from(u, device="cpu"), [4, 1], 2,
                  mask=tgb.Vector.dense_from(m, device="cpu"), desc=td))
    v = np.asarray([7.0, 8.0, 9.0], np.float32)
    _same(jgb.assign_matrix_row(JC, jgb.Vector.dense_from(v), 3, [0, 4, 2],
                                accum=jgb.Minimum),
          tgb.assign_matrix_row(TC, tgb.Vector.dense_from(v, device="cpu"),
                                3, [0, 4, 2], accum=tgb.Minimum))


def test_assign_matrix_checks_and_int_dtype():
    """The checks of tests/test_matrix_assign.py, and an int32 Matrix above
    2^24 keeps its dtype and values through the construction ops."""
    rng = np.random.default_rng(6)
    _, TC = _mat(rng, 5, 5, 10)
    _, TA = _mat(rng, 2, 2, 3)
    with pytest.raises(DimensionException):
        tgb.assign_matrix(TC, TA, [0, 1, 2], [0, 1])
    with pytest.raises(ValueError, match="duplicate"):
        tgb.assign_matrix(TC, TA, [1, 1], [0, 1])
    big = np.int32(2 ** 24 + 1)
    Ti = tgb.Matrix.from_coo([0, 1], [0, 1], np.asarray([big, 7], np.int32),
                             4, 4, dtype=torch.int32, device="cpu")
    out = tgb.assign_matrix_scalar(Ti, 5, [2], [3])
    assert out.dtype == torch.int32 and int(out.to_dense()[0, 0]) == big
    out2 = tgb.eWiseAdd_matrix(Ti, Ti, tgb.PlusMultipliesSemiring)
    assert int(out2.to_dense()[1, 1]) == 14


@pytest.mark.parametrize("op", ["PlusMultipliesSemiring",
                                "MinimumPlusSemiring", "Minus", "Maximum"])
@pytest.mark.parametrize("masked", [False, True])
def test_ewiseadd_matrix_matches_jax(op, masked):
    """C = mask .* (A ⊕ B) over the union, A's entry first for a
    non-commutative op (tests/test_matrix_assign.py's cases)."""
    rng = np.random.default_rng(9)
    JA, TA = _mat(rng, 7, 7, 14)
    JB, TB = _mat(rng, 7, 7, 14)
    JM, TM = _pair([0, 2, 3], [0, 2, 5], np.ones(3), 7, 7)
    _same(jgb.eWiseAdd_matrix(JA, JB, getattr(jgb, op),
                              mask=JM if masked else None),
          tgb.eWiseAdd_matrix(TA, TB, getattr(tgb, op),
                              mask=TM if masked else None))
    with pytest.raises(DimensionException):
        tgb.eWiseAdd_matrix(TA, _mat(rng, 7, 4, 5)[1], getattr(tgb, op))


# ------------------------------------------------------------ scaling
@pytest.mark.parametrize("fn", ["scale_matrix", "scale_matrix_rows",
                                "scale_matrix_cols"])
@pytest.mark.parametrize("graph", ["chesapeake", "directed"])
def test_scaling_matches_jax(chesapeake, fn, graph):
    """scale_matrix by a scalar, and rows / columns by a vector: every
    padded slot too, where the sentinel ids read the vector's last entry,
    as JAX's clamp has them. One float op a value: 1e-6 relative."""
    if graph == "chesapeake":
        J, T = chesapeake
    else:
        J, T = _mat(np.random.default_rng(3), 20, 30, 90)
    rng = np.random.default_rng(4)
    if fn == "scale_matrix":
        jr = jgb.scale_matrix(J, jgb.Multiplies, 3.0)
        tr = tgb.scale_matrix(T, tgb.Multiplies, 3.0)
    else:
        n = J.nrows if fn == "scale_matrix_rows" else J.ncols
        vec = (rng.random(n) + 0.5).astype(np.float32)
        jr = getattr(jops, fn)(J, jgb.Vector.dense_from(vec),
                               jgb.PlusMinusSemiring)
        tr = getattr(tgb, fn)(T, tgb.Vector.dense_from(vec, device="cpu"),
                              tgb.PlusMinusSemiring)
    _same(jr, tr, rtol=1e-6)


# ------------------------------------------------------------ reduce
@pytest.mark.parametrize("monoid", [m.name for m in tgb.ALL_MONOIDS])
@pytest.mark.parametrize("graph", ["chesapeake", "directed"])
def test_reduce_matrix_to_vector_every_monoid(chesapeake, monoid, graph):
    """The row reduce over every monoid of ALL_MONOIDS, the non-associative
    ones included: segment_reduce_csr on both sides, so exact, the float
    sum within 1e-6 relative."""
    if graph == "chesapeake":
        J, T = chesapeake
    else:
        rng = np.random.default_rng(8)
        flat = rng.choice(30 * 30, 200, replace=False)
        vals = rng.integers(-2, 3, 200).astype(np.float32)
        J, T = _pair(flat // 30, flat % 30, vals, 30, 30)
    want = np.asarray(jgb.reduce_matrix_to_vector(
        J, getattr(jgb, monoid)).to_numpy())
    got = tgb.reduce_matrix_to_vector(T, getattr(tgb, monoid)).to_numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("monoid", ["PlusMonoid", "MinimumMonoid",
                                    "MaximumMonoid", "LogicalOrMonoid"])
def test_reduce_matrix_matches_jax(chesapeake, monoid):
    """matrix → scalar over the padded value slots (the identity in the
    pads): exact."""
    J, T = chesapeake
    np.testing.assert_array_equal(
        tgb.reduce_matrix(T, getattr(tgb, monoid)).numpy(),
        np.asarray(jgb.reduce_matrix(J, getattr(jgb, monoid))))
