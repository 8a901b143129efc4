"""The port's push (ops/spmspv.py), segment_reduce_sorted and the PUSHONLY
branch of mxv_dual, BFS and SSSP against the JAX package.

Inputs are made with NumPy from a seed and handed to both packages; the
port runs on CPU tensors, so its gathers take K6's plain version, and the
JAX push (plain jnp) runs as it does off the TPU.

Tolerances. Degrees, expansions, sparse images, counts, BFS levels and
SSSP distances are exact. Min, Max and LogicalOr results are exact: the
port's sorts are stable, -0.0 and +0.0 tie and NaN sorts last, as in
`lax.sort` (np.testing's equality takes -0.0 == +0.0 and NaN == NaN; one
test pins which zero the port keeps). Plus sums may differ from JAX's by
their order within a segment: rtol 1e-5, atol 1e-5 on float32 sums of a
few dozen standard-normal terms. The value sets of the other cases are
signed powers of two and ±0, ±inf, NaN, so their sums and products are
exact in any order.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops import dispatch as jdisp
from graphblast_tpu.ops import segops as jseg
from graphblast_tpu.ops import spmspv as jpush
from graphblast_tpu_torch.ops import dispatch as tdisp
from graphblast_tpu_torch.ops import segops as tseg
from graphblast_tpu_torch.ops import spmspv as tpush
from graphblast_tpu_torch.ops.kernels import bitmap_push as tbit

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MAXF = float(np.finfo(np.float32).max)
PUSH_RTOL = dict(rtol=1e-5, atol=1e-5)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
POW2 = np.array([0.5, 1, 2, 4, -0.5, -1, -2], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return None if x is None else np.asarray(x)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else _t(a)


def _values(rng, m, specials=0.1):
    """Signed powers of two with a share of ±0, ±inf and NaN."""
    v = rng.choice(POW2, m)
    hit = rng.random(m) < specials
    v[hit] = rng.choice(SPECIALS, int(hit.sum()))
    return v.astype(np.float32)


def _rect_coo(seed=1, n_r=300, n_c=200, m=2200):
    """A directed rectangular graph, unique edges, special values."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_r, m).astype(np.int64) * n_c
                    + rng.integers(0, n_c, m))
    rows, cols = key // n_c, key % n_c
    return rows, cols, _values(rng, len(key)), n_r, n_c


def _carry(J):
    """The port's Matrix over the JAX Matrix's arrays."""
    arrays = {k: _np(getattr(J, k)) for k in tgb.matrix.LEAVES}
    return tgb.Matrix.from_numpy_arrays(arrays, J.nrows, J.ncols, J.nvals,
                                        J.symmetric, device="cpu")


def _graphs(name):
    """(JAX Matrix, port Matrix) for one named test graph."""
    if name == "chesapeake":
        path = os.path.join(DATA, "chesapeake.mtx")
        return (jgb.Matrix.from_mtx(path, use_cache=False),
                tgb.Matrix.from_mtx(path, use_cache=False, device="cpu"))
    if name == "rmat10":
        from graphblast_tpu.io.rmat import rmat_matrix as jrmat
        from graphblast_tpu_torch.io.rmat import rmat_matrix

        return jrmat(10, 16, seed=42), rmat_matrix(10, 16, seed=42,
                                                   device="cpu")
    if name == "grid16":
        from graphblast_tpu.io.rmat import grid_matrix as jgrid
        from graphblast_tpu_torch.io.rmat import grid_matrix

        return jgrid(16), grid_matrix(16, device="cpu")
    if name == "rect":
        rows, cols, vals, n_r, n_c = _rect_coo()
        J = jgb.Matrix.from_coo(rows, cols, vals, n_r, n_c)
        return J, _carry(J)
    if name == "directed":
        rng = np.random.default_rng(7)
        n, m = 3000, 25000
        key = np.unique(rng.integers(0, n, m).astype(np.int64) * n
                        + rng.integers(0, n, m))
        rows, cols = key // n, key % n
        vals = (rng.random(len(key)) * 4 + 0.5).astype(np.float32)
        J = jgb.Matrix.from_coo(rows, cols, vals, n, n)
        return J, _carry(J)
    raise KeyError(name)


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in
            ("chesapeake", "rmat10", "grid16", "rect", "directed")}


def _frontier(n, ids, vals=None):
    """Padded (ind, val, nvals) of a sparse frontier over n vertices:
    ascending ids, sentinel n in the pads."""
    ids = np.sort(np.asarray(ids, np.int64))
    ind = np.full(n, n, np.int32)
    ind[:len(ids)] = ids
    val = np.zeros(n, np.float32)
    if vals is not None:
        val[:len(ids)] = vals
    return ind, val, len(ids)


# ------------------------------------------------- segment_reduce_sorted
MONOIDS = ["PlusMonoid", "MinimumMonoid", "MaximumMonoid",
           "LogicalOrMonoid", "MultipliesMonoid"]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("monoid", MONOIDS)
def test_segment_reduce_sorted_matches_jax(monoid, dtype):
    """Sorted ids with a tail of padding ids (>= num_segments), which both
    drop; int32 products wrap alike. Exact."""
    rng = np.random.default_rng(3)
    m, nseg = 3000, 400
    ids = np.sort(rng.integers(0, nseg + 40, m)).astype(np.int32)
    vals = (rng.integers(-5, 6, m).astype(np.int32) if dtype == np.int32
            else _values(rng, m, specials=0.05))
    want = jseg.segment_reduce_sorted(jnp.asarray(vals), jnp.asarray(ids),
                                      getattr(jgb.semiring, monoid), nseg)
    got = tseg.segment_reduce_sorted(_t(vals), _t(ids),
                                     getattr(tgb.semiring, monoid), nseg)
    assert got.dtype == _t(vals).dtype and got.shape == (nseg,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------- degrees and the expansion
FRONTIER_KINDS = ["empty", "single", "last", "zero_degree", "cap"]


def _expand_case(T, kind, rng):
    """(frontier ids, edge_cap) of one kind over the CSR of T."""
    n = T.nrows
    deg = np.diff(T.host_csr()[0])
    if kind == "empty":
        return [], 1024
    if kind == "single":
        return [int(np.argmax(deg))], 1024
    if kind == "last":
        return [n - 1], 1024
    if kind == "zero_degree":
        # the graph's zero-degree vertices (where it has any) among others
        zeros = np.flatnonzero(deg == 0)[:8]
        return np.union1d(zeros, rng.choice(n, 6, replace=False)), 4096
    ids = rng.choice(np.flatnonzero(deg > 0), 6, replace=False)
    return ids, int(deg[ids].sum())   # a degree total equal to the cap


@pytest.mark.parametrize("kind", FRONTIER_KINDS)
@pytest.mark.parametrize("name", ["chesapeake", "rmat10"])
def test_frontier_degrees_and_expansion_match_jax(graphs, name, kind):
    """dst, mv, valid and total of the expansion (and the degrees) equal
    JAX's lane for lane, the pad lanes included."""
    J, T = graphs[name]
    rng = np.random.default_rng(5)
    ids, cap = _expand_case(T, kind, rng)
    ind, val, nv = _frontier(T.nrows, ids, _values(rng, len(ids), 0.0))
    if kind == "zero_degree" and name == "rmat10":
        assert (np.diff(T.host_csr()[0])[ids] == 0).any()
    jdeg = jpush.frontier_degrees(J.row_ptr, jnp.asarray(ind), nv)
    tdeg = tpush.frontier_degrees(T.row_ptr, _t(ind), nv)
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    want = jpush.expand_frontier(
        J.row_ptr, J.col_ind, J.val, jnp.asarray(ind), jnp.asarray(val), nv,
        cap, False, jgb.PlusMultipliesSemiring, jnp.float32)
    got = tpush.expand_frontier(
        T.row_ptr, T.col_ind, T.val, _t(ind), _t(val), nv, cap, False,
        tgb.PlusMultipliesSemiring, torch.float32)
    for w, g, what in zip(want, got, ("dst", "mv", "valid", "total")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    assert int(got[3]) == int(np.diff(T.host_csr()[0])[ids].sum())
    if kind == "cap":
        assert int(got[3]) == cap and bool(got[2].all())


# ------------------------------------------------------------- the push
# (class, semiring name, structure_only): LogicalOr struconly (the bitmap
# push), LogicalOr over values, Plus (a - b: swap_mul shows), Min (select
# second: swap_mul shows), Max, and a generic ⊕ (Multiplies, the scan)
PUSH_CLASSES = [
    ("or_struct", "LogicalOrAndSemiring", True),
    ("or_values", "LogicalOrAndSemiring", False),
    ("plus", "PlusMinusSemiring", False),
    ("min", "MinimumSelectSecondSemiring", False),
    ("max", "MaximumMultipliesSemiring", False),
    ("generic", "MultipliesMultipliesSemiring", False),
]


def _orient(G, transpose):
    """(ptr, ind, val, n_in, n_out) of the push orientation: the CSR for
    vxm (transpose), the CSC for mxv."""
    if transpose:
        return G.row_ptr, G.col_ind, G.val, G.nrows, G.ncols
    return G.col_ptr, G.csc_row_ind, G.csc_val, G.ncols, G.nrows


def _push_inputs(graphs, transpose, mask_kind, seed=9, value_fn=_values):
    J, T = graphs["rect"]
    rng = np.random.default_rng(seed)
    jarr, tarr = _orient(J, transpose), _orient(T, transpose)
    n_in, n_out = tarr[3], tarr[4]
    ids = np.flatnonzero(rng.random(n_in) < 0.3)
    ind, val, nv = _frontier(n_in, ids, value_fn(rng, len(ids)))
    mask = (rng.random(n_out) < 0.5).astype(np.float32)
    mk = None if mask_kind == "none" else mask
    return jarr, tarr, (ind, val, nv), mk, mask_kind == "complement"


def _compare_sparse(got, want, n_out, exact):
    y, sind, sval, nv = got
    jy, jsind, jsval, jnv = (np.asarray(a) if a is not None else None
                             for a in want)
    assert int(nv) == int(jnv)
    k = int(nv)
    np.testing.assert_array_equal(sind.numpy()[:k], jsind[:k])
    assert (sind.numpy()[k:] == n_out).all()
    check = (np.testing.assert_array_equal if exact
             else lambda a, b: np.testing.assert_allclose(a, b, **PUSH_RTOL))
    check(y.numpy(), jy)
    if jsval is not None:
        check(sval.numpy()[:k], jsval[:k])
    else:
        assert sval is None


@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
@pytest.mark.parametrize("swap_mul", [False, True])
@pytest.mark.parametrize("sort_push", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "mask", "complement"])
@pytest.mark.parametrize("cls,sr,struc", PUSH_CLASSES,
                         ids=[c[0] for c in PUSH_CLASSES])
def test_push_matches_jax(graphs, cls, sr, struc, mask_kind, sort_push,
                          swap_mul, transpose):
    """spmspv_push (each lowering) and spmspv_push_sparse against JAX on a
    rectangular graph whose values and frontier hold ±0, ±inf and NaN.
    Exact: the value sets make every sum and product exact."""
    jarr, tarr, (ind, val, nv), mk, scmp = _push_inputs(
        graphs, transpose, mask_kind)
    n_out = tarr[4]
    cap = int(tarr[1].shape[0])
    jsr, tsr = getattr(jgb.semiring, sr), getattr(tgb.semiring, sr)
    fv = None if struc else val
    kw = dict(mask_scmp=scmp, structure_only=struc, swap_mul=swap_mul)
    want = jpush.spmspv_push(
        *jarr[:3], jnp.asarray(ind), _j(fv), nv, jsr, n_out, cap,
        mask_dense=_j(mk), sort_push=sort_push, **kw)
    got = tpush.spmspv_push(
        *tarr[:3], _t(ind), _tt(fv), nv, tsr, n_out, cap,
        mask_dense=_tt(mk), sort_push=sort_push, **kw)
    assert got.dtype == torch.float32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if sort_push:
        want = jpush.spmspv_push_sparse(
            *jarr[:3], jnp.asarray(ind), _j(fv), nv, jsr, n_out, cap,
            mask_dense=_j(mk), with_values=not struc, **kw)
        got = tpush.spmspv_push_sparse(
            *tarr[:3], _t(ind), _tt(fv), nv, tsr, n_out, cap,
            mask_dense=_tt(mk), with_values=not struc, **kw)
        _compare_sparse(got, want, n_out, exact=True)


@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
@pytest.mark.parametrize("sort_push", [True, False])
def test_plus_push_on_normal_values_matches_jax(graphs, transpose,
                                                sort_push):
    """PlusMultiplies over standard-normal values and frontier: the sums'
    order within a segment differs, so within PUSH_RTOL."""
    def normal(rng, m):
        return rng.standard_normal(m).astype(np.float32)

    jarr, tarr, (ind, val, nv), mk, _ = _push_inputs(
        graphs, transpose, "mask", seed=4, value_fn=normal)
    vals = normal(np.random.default_rng(8), int(jarr[2].shape[0]))
    jval, tval = jnp.asarray(vals), _t(vals)
    n_out, cap = tarr[4], int(tarr[1].shape[0])
    want = jpush.spmspv_push(jarr[0], jarr[1], jval, jnp.asarray(ind),
                             jnp.asarray(val), nv,
                             jgb.PlusMultipliesSemiring, n_out, cap,
                             mask_dense=jnp.asarray(mk), sort_push=sort_push)
    got = tpush.spmspv_push(tarr[0], tarr[1], tval, _t(ind), _t(val), nv,
                            tgb.PlusMultipliesSemiring, n_out, cap,
                            mask_dense=_t(mk), sort_push=sort_push)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PUSH_RTOL)
    want = jpush.spmspv_push_sparse(jarr[0], jarr[1], jval, jnp.asarray(ind),
                                    jnp.asarray(val), nv,
                                    jgb.PlusMultipliesSemiring, n_out, cap,
                                    mask_dense=jnp.asarray(mk))
    got = tpush.spmspv_push_sparse(tarr[0], tarr[1], tval, _t(ind), _t(val),
                                   nv, tgb.PlusMultipliesSemiring, n_out,
                                   cap, mask_dense=_t(mk))
    _compare_sparse(got, want, n_out, exact=False)


def _star(values, sr_name, sort_push, sparse):
    """Vertices 0..k-1 (values `values`) each with one edge to vertex k,
    pushed with `sr_name` over the CSR (vxm): both packages' y[k]."""
    k = len(values)
    rows, cols = np.arange(k), np.full(k, k)
    J = jgb.Matrix.from_coo(rows, cols, np.ones(k, np.float32), k + 1, k + 1)
    T = _carry(J)
    ind, val, nv = _frontier(k + 1, np.arange(k), values)
    cap = int(T.nnz_pad)
    jsr, tsr = getattr(jgb.semiring, sr_name), getattr(tgb.semiring, sr_name)
    if sparse:
        jy = jpush.spmspv_push_sparse(J.row_ptr, J.col_ind, J.val,
                                      jnp.asarray(ind), jnp.asarray(val), nv,
                                      jsr, k + 1, cap)[0]
        ty = tpush.spmspv_push_sparse(T.row_ptr, T.col_ind, T.val, _t(ind),
                                      _t(val), nv, tsr, k + 1, cap)[0]
    else:
        jy = jpush.spmspv_push(J.row_ptr, J.col_ind, J.val, jnp.asarray(ind),
                               jnp.asarray(val), nv, jsr, k + 1, cap,
                               sort_push=sort_push)
        ty = tpush.spmspv_push(T.row_ptr, T.col_ind, T.val, _t(ind), _t(val),
                               nv, tsr, k + 1, cap, sort_push=sort_push)
    return float(np.asarray(jy)[k]), float(ty.numpy()[k])


def test_min_segment_keeps_which_zero_and_skips_nan():
    """One destination fed -0.0, +0.0 (and NaN) through MinimumSelectSecond.
    The MERGE push keeps the zero that comes first in lane order (the
    stable sort ties -0.0 with +0.0) and skips NaN, which sorts last; the
    SIMPLE scatter-min propagates NaN, in both packages. Values agree with
    JAX's; JAX's zero sign is its sort's (or its scatter's) choice."""
    for first in (-0.0, 0.0):
        for sparse in (True, False):
            j, t = _star(np.array([first, -first, 1.0], np.float32),
                         "MinimumSelectSecondSemiring", True, sparse)
            assert j == t == 0.0 and np.signbit(t) == np.signbit(first)
    for sparse in (True, False):
        j, t = _star(np.array([np.nan, 2.0, 1.0], np.float32),
                     "MinimumSelectSecondSemiring", True, sparse)
        assert j == t == 1.0
    j, t = _star(np.array([np.nan, 2.0, 1.0], np.float32),
                 "MinimumSelectSecondSemiring", False, False)
    assert np.isnan(j) and np.isnan(t)
    # Max: NaN sorts last, so the tail (the MERGE max) is NaN
    j, t = _star(np.array([1.0, np.nan, 2.0], np.float32),
                 "MaximumMultipliesSemiring", True, False)
    assert np.isnan(j) and np.isnan(t)


def test_identity_valued_segments_are_dropped_in_both_images(graphs):
    """A segment whose ⊕-total is the identity leaves no sparse entry and
    the identity in the dense image: a Max segment of zeros (identity 0)
    and a MinimumPlus candidate of FLT_MAX."""
    for vals, sr in (([0.0, -0.0, 0.0], "MaximumMultipliesSemiring"),
                     ([MAXF, MAXF, MAXF], "MinimumSelectSecondSemiring")):
        k = len(vals)
        rows, cols = np.arange(k), np.full(k, k)
        J = jgb.Matrix.from_coo(rows, cols, np.ones(k, np.float32), k + 1,
                                k + 1)
        T = _carry(J)
        ind, val, nv = _frontier(k + 1, np.arange(k), vals)
        args = (jnp.asarray(ind), jnp.asarray(val), nv,
                getattr(jgb.semiring, sr), k + 1, int(T.nnz_pad))
        want = jpush.spmspv_push_sparse(J.row_ptr, J.col_ind, J.val, *args)
        got = tpush.spmspv_push_sparse(
            T.row_ptr, T.col_ind, T.val, _t(ind), _t(val), nv,
            getattr(tgb.semiring, sr), k + 1, int(T.nnz_pad))
        assert int(got[3]) == int(want[3]) == 0
        ident = float(getattr(tgb.semiring, sr).identity(torch.float32))
        assert got[0][k] == ident
        _compare_sparse(got, want, k + 1, exact=True)


# ----------------------------------------- the push against the port's pull
def _dual(x, ident):
    return tdisp.DualFrontier.from_dense(_t(x), ident)


def _mxv(T, x, sr, ident, mode, **kw):
    f2, used_push = tdisp.mxv_dual(T, _dual(x, ident), sr, ident, mode=mode,
                                   **kw)
    assert used_push == (mode == tgb.Direction.PUSHONLY)
    return f2


PULL_SEMIRINGS = ["PlusMultipliesSemiring", "MinimumPlusSemiring",
                  "MaximumMultipliesSemiring", "LogicalOrAndSemiring",
                  "MinimumSelectSecondSemiring"]


@pytest.mark.parametrize("sr_name", PULL_SEMIRINGS)
def test_push_equals_pull_per_semiring(graphs, sr_name):
    """Twin of tests/test_ops.py test_mxv_semirings through mxv_dual: on
    chesapeake, a frontier of identity and live entries, the push's dense
    image equals the pull's and a dense reference (rtol 1e-4 as there)."""
    _, T = graphs["chesapeake"]
    sr = getattr(tgb.semiring, sr_name)
    ident = float(sr.identity(torch.float32))
    rng = np.random.RandomState(0)
    x = (rng.rand(T.ncols) * 4).astype(np.float32)
    x[rng.rand(T.ncols) < 0.5] = ident
    push = _mxv(T, x, sr, ident, tgb.Direction.PUSHONLY)
    pull = _mxv(T, x, sr, ident, tgb.Direction.PULLONLY)
    np.testing.assert_allclose(push.dense.numpy(), pull.dense.numpy(),
                               rtol=1e-4, atol=1e-5)
    Ad = np.zeros((T.nrows, T.ncols), np.float32)
    r, c, v = T.extract_tuples()
    Ad[r, c] = v
    want = np.full(T.nrows, ident, np.float32)
    for i, j in zip(r, c):
        want[i] = sr.add(torch.tensor(want[i]),
                         sr.mul(torch.tensor(Ad[i, j]), torch.tensor(x[j])))
    np.testing.assert_allclose(push.dense.numpy(), want, rtol=1e-4,
                               atol=1e-5)
    assert int(push.snvals) == int((push.dense != ident).sum())


def test_push_vxm_is_transpose_mxv():
    """Twin of tests/test_ops.py test_vxm_is_transpose_mxv: on a
    rectangular graph the vxm push over the CSR equals Aᵀ·x, the mxv push
    over the CSC A·x, and each the pull, within rtol 1e-4 and atol 1e-5:
    the pull differences prefix sums over all the edges, so its error
    is absolute, about eps·Σ|a·x|."""
    rows, cols, _, n_r, n_c = _rect_coo()
    vals = np.random.RandomState(0).rand(len(rows)).astype(np.float32)
    T = tgb.Matrix.from_coo(rows, cols, vals, n_r, n_c, device="cpu")
    Ad = np.zeros((n_r, n_c), np.float32)
    Ad[rows, cols] = vals
    rng = np.random.RandomState(1)
    for transpose in (True, False):
        x = rng.rand(n_r if transpose else n_c).astype(np.float32)
        want = Ad.T @ x if transpose else Ad @ x
        kw = dict(transpose=transpose)
        push = _mxv(T, x, tgb.PlusMultipliesSemiring, 0.0,
                    tgb.Direction.PUSHONLY, **kw)
        pull = _mxv(T, x, tgb.PlusMultipliesSemiring, 0.0,
                    tgb.Direction.PULLONLY, **kw)
        np.testing.assert_allclose(push.dense.numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(push.dense.numpy(), pull.dense.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_masked_push_equals_pull(graphs):
    """Twin of tests/test_ops.py test_masked_push: the structure-only or
    push from three sources under a complemented mask."""
    _, T = graphs["chesapeake"]
    rng = np.random.RandomState(2)
    m = (rng.rand(T.nrows) < 0.5).astype(np.float32)
    x = np.zeros(T.ncols, np.float32)
    x[[0, 5, 9]] = 1
    kw = dict(mask_dense=_t(m), mask_scmp=True, structure_only=True)
    push = _mxv(T, x, tgb.LogicalOrAndSemiring, 0.0, tgb.Direction.PUSHONLY,
                **kw)
    pull = _mxv(T, x, tgb.LogicalOrAndSemiring, 0.0, tgb.Direction.PULLONLY,
                **kw)
    Ad = np.zeros((T.nrows, T.ncols), np.float32)
    r, c, _ = T.extract_tuples()
    Ad[r, c] = 1
    want = (Ad @ x > 0).astype(np.float32)
    want[m != 0] = 0
    np.testing.assert_array_equal(push.dense.numpy(), want)
    np.testing.assert_array_equal(pull.dense.numpy(), want)
    assert push.sval is None and int(push.snvals) == int(want.sum())


def test_push_sparse_output_matches_dense(graphs):
    """Twin of tests/test_ops.py test_push_sparse_output_matches_dense:
    spmspv_push_sparse's (y, sind, sval, nv) equal the dense push and
    sparse_from_dense, for each monoid class and mask."""
    from graphblast_tpu_torch.vector import sparse_from_dense

    _, T = graphs["chesapeake"]
    n = T.nrows
    ind, val, nv = _frontier(n, [0, 3, 9, 17, 25], [1.5, 2.0, 0.5, 3.0, 1.0])
    ind, val = _t(ind), _t(val)
    mask = _t((np.random.RandomState(3).rand(n) < 0.5).astype(np.float32))
    cap = int(T.nnz_pad)
    cases = [(tgb.PlusMultipliesSemiring, False, None, False),
             (tgb.PlusMultipliesSemiring, False, mask, False),
             (tgb.MinimumPlusSemiring, False, mask, True),
             (tgb.MaximumMultipliesSemiring, False, None, False),
             (tgb.LogicalOrAndSemiring, True, mask, True),
             (tgb.MinimumSelectSecondSemiring, False, None, False)]
    for sr, struc, mk, scmp in cases:
        ident = float(sr.identity(torch.float32))
        kw = dict(mask_dense=mk, mask_scmp=scmp, structure_only=struc)
        fv = None if struc else val
        y_d = tpush.spmspv_push(T.col_ptr, T.csc_row_ind, T.csc_val, ind, fv,
                                nv, sr, n, cap, **kw)
        si_d, sv_d, nv_d = sparse_from_dense(y_d, ident,
                                             with_values=not struc)
        y_s, si_s, sv_s, nv_s = tpush.spmspv_push_sparse(
            T.col_ptr, T.csc_row_ind, T.csc_val, ind, fv, nv, sr, n, cap,
            with_values=not struc, **kw)
        tag = str((sr.name, struc, mk is not None, scmp))
        np.testing.assert_allclose(y_s.numpy(), y_d.numpy(), rtol=1e-6,
                                   err_msg=tag)
        k = int(nv_d)
        assert int(nv_s) == k, tag
        np.testing.assert_array_equal(si_s.numpy(), si_d.numpy(),
                                      err_msg=tag)
        if not struc:
            np.testing.assert_allclose(sv_s.numpy()[:k], sv_d.numpy()[:k],
                                       rtol=1e-6, err_msg=tag)


FUZZ_SEMIRINGS = ["PlusMultipliesSemiring", "MinimumPlusSemiring",
                  "LogicalOrAndSemiring", "MaximumMultipliesSemiring"]


@pytest.mark.parametrize("name", FUZZ_SEMIRINGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_push_equals_pull(seed, name):
    """Twin of tests/test_fuzz.py test_fuzz_matvec through mxv_dual:
    random rectangular graphs, mxv and vxm, with no mask, a mask and its
    complement; the push's dense image equals the pull's and a dense
    evaluation (rtol 1e-4, atol 1e-5 as there)."""
    rng = np.random.default_rng(100 + seed)
    n_r, n_c = int(rng.integers(20, 90)), int(rng.integers(20, 90))
    m = int(rng.integers(1, n_r * n_c // 3))
    key = np.unique(rng.integers(0, n_r, m).astype(np.int64) * n_c
                    + rng.integers(0, n_c, m))
    rows, cols = key // n_c, key % n_c
    vals = (rng.random(len(key)) * 4 + 0.5).astype(np.float32)
    T = tgb.Matrix.from_coo(rows, cols, vals, n_r, n_c, device="cpu")
    sr = getattr(tgb.semiring, name)
    ident = float(sr.identity(torch.float32))
    for transpose in (False, True):
        n_in, n_out = (n_r, n_c) if transpose else (n_c, n_r)
        x = np.where(rng.random(n_in) < 0.4, np.float32(ident),
                     rng.random(n_in) * 3 + 0.5).astype(np.float32)
        # dense evaluation over the stored entries, ⊕ folded edge by edge
        want = torch.full((n_out,), ident)
        o, i = (cols, rows) if transpose else (rows, cols)
        for oo, ii, a in zip(o, i, vals):
            want[oo] = sr.add(want[oo], sr.mul(torch.tensor(a),
                                               torch.tensor(x[ii])))
        mask = (rng.random(n_out) < 0.5).astype(np.float32)
        for use_mask, scmp in ((False, False), (True, False), (True, True)):
            kw = dict(transpose=transpose, mask_scmp=scmp,
                      mask_dense=_t(mask) if use_mask else None)
            push = _mxv(T, x, sr, ident, tgb.Direction.PUSHONLY, **kw)
            pull = _mxv(T, x, sr, ident, tgb.Direction.PULLONLY, **kw)
            ref = want.numpy()
            if use_mask:
                ref = np.where((mask == 0) if scmp else (mask != 0), ref,
                               np.float32(ident))
            tag = f"{name} t={transpose} mask={use_mask} scmp={scmp}"
            np.testing.assert_allclose(push.dense.numpy(), ref, rtol=1e-4,
                                       atol=1e-5, err_msg=tag)
            np.testing.assert_allclose(push.dense.numpy(),
                                       pull.dense.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=tag)


# ---------------------------------------------------- mxv_dual PUSHONLY
def _tier_frontier(T, lo, hi, rng):
    """Ids of a frontier whose degree total (over the CSR) is in (lo, hi]."""
    deg = np.diff(T.host_csr()[0])
    order = rng.permutation(np.flatnonzero(deg > 0))
    total = np.cumsum(deg[order])
    k = int(np.searchsorted(total, hi, side="right"))
    assert total[k - 1] > lo
    return np.sort(order[:k])


DUAL_CASES = [
    # (name, semiring, structure_only, mask, postprocess)
    ("bfs", "LogicalOrAndSemiring", True, True, False),
    ("sssp", "MinimumPlusSemiring", False, False, True),
    ("plus", "PlusMultipliesSemiring", False, True, False),
]


@pytest.mark.parametrize("sort_push", [True, False])
@pytest.mark.parametrize("tier", [0, 1, 2])
@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
@pytest.mark.parametrize("case,sr_name,struc,masked,post", DUAL_CASES,
                         ids=[c[0] for c in DUAL_CASES])
def test_mxv_dual_pushonly_matches_jax(graphs, case, sr_name, struc, masked,
                                       post, transpose, tier, sort_push):
    """mxv_dual PUSHONLY against JAX's on a directed graph (nnz_pad 25,600,
    JAX's tiers 1,024, 4,096 and 25,600): dense, sind[:nv], sval[:nv],
    snvals and use_sparse, with a frontier that lands in each of JAX's
    tiers; the port's lanes follow its route (`_lanes_by_hand`). SSSP's
    case carries the postprocess and its sparse twin."""
    J, T = graphs["directed"]
    rng = np.random.default_rng(20 + tier)
    bounds = [(0, 1024), (1024, 4096), (4096, 8000)][tier]
    ids = _tier_frontier(T, *bounds, rng)
    jsr, tsr = getattr(jgb.semiring, sr_name), getattr(tgb.semiring, sr_name)
    ident = float(tsr.identity(torch.float32))
    x = np.full(T.nrows, ident, np.float32)
    x[ids] = 1.0 if struc else rng.random(len(ids)) * 3 + 0.5
    v = ((rng.random(T.nrows) < 0.5) * rng.random(T.nrows) * 4).astype(
        np.float32)
    kw = dict(transpose=transpose, mask_scmp=True, structure_only=struc,
              sort_push=sort_push)
    jkw = dict(kw, mask_dense=jnp.asarray(v) if masked else None)
    tkw = dict(kw, mask_dense=_t(v) if masked else None)
    if post:
        def jpost(y):
            return jnp.where(y < jnp.asarray(v), y, MAXF)

        def jpost_s(keys, vals):
            return jnp.where(vals < jnp.asarray(v)[keys], vals, MAXF)

        def tpost(y):
            return torch.where(y < _t(v), y, MAXF)

        def tpost_s(keys, vals):
            return torch.where(vals < _t(v)[keys.long()], vals, MAXF)

        jkw.update(postprocess=jpost, postprocess_sparse=jpost_s)
        tkw.update(postprocess=tpost, postprocess_sparse=tpost_s)
    jf, jpushed = jdisp.mxv_dual(
        J, jdisp.DualFrontier.from_dense(jnp.asarray(x), ident), jsr, ident,
        mode=jgb.Direction.PUSHONLY, **jkw)
    lanes = tdisp.mxv_dual.push_lanes
    tf, tpushed = tdisp.mxv_dual(T, _dual(x, ident), tsr, ident,
                                 mode=tgb.Direction.PUSHONLY, **tkw)
    lanes = tdisp.mxv_dual.push_lanes - lanes
    assert bool(jpushed) and tpushed is True
    exact = sr_name != "PlusMultipliesSemiring"
    _compare_sparse((tf.dense, tf.sind, tf.sval, tf.snvals),
                    (jf.dense, jf.sind, jf.sval, jf.snvals), T.nrows, exact)
    assert bool(tf.use_sparse) == bool(jf.use_sparse)
    deg_total = int(tdisp._frontier_degree_total(
        T.row_ptr if transpose else T.col_ptr, _dual(x, ident), ident))
    assert lanes == _lanes_by_hand(case, deg_total, len(ids), T.nnz_pad)
    if transpose:   # the CSR's degrees chose the frontier
        assert bounds[0] < deg_total <= bounds[1]


def _lanes_by_hand(case, deg_total, snvals, edge_cap):
    """The lanes of one push of a DUAL_CASES case: BFS's bitmap push covers
    whole blocks of 4,096 edges, SSSP's slices one lane an edge, and the
    PlusMultiplies push a workspace of max(deg_total, snvals) rounded up to
    1,024 (at least 1,024), at most edge_cap."""
    if case == "bfs":
        return -(-deg_total // 4096) * 4096
    if case == "sssp":
        return deg_total
    return min(edge_cap, max(-(-max(deg_total, snvals) // 1024) * 1024,
                             1024))


def _sparse_rows(n=3000, hot=200, m=1000, seed=9):
    """(JAX Matrix, port Matrix): edges only out of the first `hot` of n
    vertices, so most vertices have degree 0."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, hot, m).astype(np.int64) * n
                    + rng.integers(0, n, m))
    J = jgb.Matrix.from_coo(key // n, key % n,
                            (rng.random(len(key)) * 4 + 0.5).astype(
                                np.float32), n, n)
    return J, _carry(J)


def _odd_to_zero(y):
    """A postprocess: y with its odd slots set to 0, in either package."""
    odd = np.arange(y.shape[0]) % 2 == 1
    if isinstance(y, torch.Tensor):
        return y.masked_fill(torch.from_numpy(odd), 0.0)
    return jnp.where(jnp.asarray(odd), 0.0, y)


# the pushes the workspace route takes: (semiring, structure_only,
# postprocess)
WORKSPACE_PUSHES = {
    "plus": ("PlusMultipliesSemiring", False, None),
    "or_valued": ("LogicalOrAndSemiring", False, None),
    "or_postprocess": ("LogicalOrAndSemiring", True, _odd_to_zero)}


@pytest.mark.parametrize("sort_push", [True, False])
@pytest.mark.parametrize("push", list(WORKSPACE_PUSHES))
def test_workspace_push_rounds_to_1024_lanes_and_stops_at_edge_cap(
        graphs, push, sort_push):
    """The workspace route (a valued PlusMultiplies push, a valued
    LogicalOrAnd one as a BFS over the frontier's values pushes, and a
    structure-only LogicalOrAnd one with a postprocess): its lanes are the
    degree total rounded up to 1,024, or the frontier's count where that
    is more (a frontier of degree-0 vertices), and edge_cap where the
    rounding would pass it; only a push at edge_cap counts as a top-tier
    push, and none as a bitmap or sliced push. Each result equals JAX's."""
    sr, struc, post = WORKSPACE_PUSHES[push]
    J, T = graphs["directed"]
    rng = np.random.default_rng(33)
    ids = _tier_frontier(T, 1500, 3000, rng)
    deg_total = int(np.diff(T.host_csr()[0])[ids].sum())
    assert deg_total % 1024 < 1000
    rounded = -(-deg_total // 1024) * 1024
    SJ, ST = _sparse_rows()
    idle = np.sort(rng.choice(np.arange(200, ST.nrows), 1400, replace=False))
    front = np.concatenate([np.arange(50), idle])
    assert int(np.diff(ST.host_csr()[0])[front].sum()) < 1024
    for (JM, TM), front, edge_cap, want, top in (
            ((J, T), ids, None, rounded, 0),
            ((J, T), ids, deg_total + 10, deg_total + 10, 1),
            ((J, T), ids, rounded, rounded, 1),
            ((SJ, ST), front, 4096, 2048, 0)):
        x = np.zeros(TM.nrows, np.float32)
        x[front] = rng.random(len(front)) * 3 + 0.5
        v = ((rng.random(TM.nrows) < 0.5) * rng.random(TM.nrows)).astype(
            np.float32)
        kw = dict(transpose=True, mask_scmp=True, sort_push=sort_push,
                  edge_cap=edge_cap, structure_only=struc, postprocess=post)
        counters = ("push_lanes", "top_tier_pushes", "bitmap_pushes",
                    "sliced_pushes")
        before = [getattr(tdisp.mxv_dual, c) for c in counters]
        tf, _ = tdisp.mxv_dual(TM, _dual(x, 0.0), getattr(tgb, sr), 0.0,
                               mode=tgb.Direction.PUSHONLY,
                               mask_dense=_t(v), **kw)
        assert [getattr(tdisp.mxv_dual, c) - b
                for c, b in zip(counters, before)] == [want, top, 0, 0]
        jf, _ = jdisp.mxv_dual(
            JM, jdisp.DualFrontier.from_dense(jnp.asarray(x), 0.0),
            getattr(jgb, sr), 0.0, mode=jgb.Direction.PUSHONLY,
            mask_dense=jnp.asarray(v), **kw)
        _compare_sparse((tf.dense, tf.sind, tf.sval, tf.snvals),
                        (jf.dense, jf.sind, jf.sval, jf.snvals), TM.nrows,
                        exact=False)


def test_mxv_dual_push_is_the_same_in_every_tier(graphs):
    """One frontier pushed by JAX in each of its tiers, forced by edge_cap
    and tier_divisors, and by the port at the same edge_cap, gives one
    result, equal to JAX's; a degree total past edge_cap raises, where JAX
    would truncate."""
    J, T = graphs["directed"]
    rng = np.random.default_rng(30)
    ids = _tier_frontier(T, 0, 1000, rng)
    x = np.zeros(T.nrows, np.float32)
    x[ids] = 1.0
    deg_total = int(np.diff(T.host_csr()[0])[ids].sum())
    runs = []
    for edge_cap, divs in ((None, (64, 8)), (None, (8,)), (None, ()),
                           (deg_total, ())):
        kw = dict(transpose=True, structure_only=True, edge_cap=edge_cap)
        tf, _ = tdisp.mxv_dual(T, _dual(x, 0.0), tgb.LogicalOrAndSemiring,
                               0.0, mode=tgb.Direction.PUSHONLY, **kw)
        jf, _ = jdisp.mxv_dual(
            J, jdisp.DualFrontier.from_dense(jnp.asarray(x), 0.0),
            jgb.LogicalOrAndSemiring, 0.0, mode=jgb.Direction.PUSHONLY,
            tier_divisors=divs, **kw)
        _compare_sparse((tf.dense, tf.sind, tf.sval, tf.snvals),
                        (jf.dense, jf.sind, jf.sval, jf.snvals), T.nrows,
                        exact=True)
        runs.append(tf)
    for tf in runs[1:]:
        assert torch.equal(tf.dense, runs[0].dense)
        assert torch.equal(tf.sind, runs[0].sind)
    with pytest.raises(ValueError, match="degree total"):
        tdisp.mxv_dual(T, _dual(x, 0.0), tgb.LogicalOrAndSemiring, 0.0,
                       transpose=True, structure_only=True,
                       edge_cap=deg_total - 1, mode=tgb.Direction.PUSHONLY)


# ------------------------------------------------------- the bitmap push
def _bitmap_frontier(T, kind, rng):
    """Frontier ids of a kind: the hub with a few others, a fifth of the
    vertices, none, or only vertices of degree 0."""
    deg = np.diff(T.host_csr()[0])[:T.nrows]
    n = T.nrows
    return {"hub": np.unique(np.append(rng.choice(n, 5), np.argmax(deg))),
            "random": rng.choice(n, n // 5, replace=False),
            "empty": np.zeros(0, np.int64),
            "deg0": np.flatnonzero(deg == 0)[:40]}[kind]


# chesapeake has no vertex of degree 0, and 39 vertices: not a multiple of
# the bitmap's 32-bit words
BITMAP_CASES = [(g, k) for g in ("rmat10", "chesapeake")
                for k in ("hub", "random", "empty", "deg0")
                if (g, k) != ("chesapeake", "deg0")]


@pytest.mark.parametrize("sr_name", ["LogicalOrAndSemiring",
                                     "MaximumMultipliesSemiring"])
@pytest.mark.parametrize("mask_kind", ["none", "scmp", "mask"])
@pytest.mark.parametrize("name,kind", BITMAP_CASES,
                         ids=[f"{g}-{k}" for g, k in BITMAP_CASES])
def test_bitmap_push_equals_the_sort_push(graphs, name, kind, mask_kind,
                                          sr_name):
    """The bitmap push (its plain version: the CPU route of mxv_dual's
    structure-only LogicalOr and Max push) equals the sort-and-segment
    push `spmspv_push_sparse` and the SIMPLE scatter with the full-n
    re-sparsification, bit for bit: y, sind and nv, and no values."""
    _, T = graphs[name]
    rng = np.random.default_rng(len(name) + len(kind) + len(mask_kind))
    n = T.nrows
    ids = _bitmap_frontier(T, kind, rng)
    f_ind, _, snv = _frontier(n, ids)
    f_ind = _t(f_ind)
    deg_total = int(np.diff(T.host_csr()[0])[ids].sum())
    assert (deg_total == 0) == (kind in ("empty", "deg0"))
    v = ((rng.random(n) < 0.5) * rng.random(n)).astype(np.float32)
    mask = None if mask_kind == "none" else _t(v)
    scmp = mask_kind == "scmp"
    sr = getattr(tgb.semiring, sr_name)
    ptr, ind = T.row_ptr, T.col_ind
    got = tbit.spmspv_push_bitmap(ptr, ind, f_ind, snv, deg_total, mask,
                                  scmp, n)
    merge = tpush.spmspv_push_sparse(
        ptr, ind, T.val, f_ind, None, torch.tensor(snv), sr, n, T.nnz_pad,
        mask, scmp, structure_only=True, with_values=False)
    y = tpush.spmspv_push(ptr, ind, T.val, f_ind, None, torch.tensor(snv),
                          sr, n, T.nnz_pad, mask, scmp, structure_only=True,
                          sort_push=False)
    simple = (y, *tgb.vector.sparse_from_dense(y, 0.0, with_values=False))
    for want in (merge, simple):
        assert got[0].dtype == want[0].dtype == torch.float32
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        assert got[2] is None and want[2] is None
        assert got[3].dtype == torch.int32 and int(got[3]) == int(want[3])
    if kind in ("hub", "random"):
        assert int(got[3]) > 0


@pytest.mark.parametrize("tiers", [(64, 8), (4096, 512, 64, 8)],
                         ids=["tiers3", "tiers5"])
@pytest.mark.parametrize("mode", ["PUSHONLY", "PUSHPULL"])
@pytest.mark.parametrize("name", ["chesapeake", "rmat10"])
def test_bfs_on_the_bitmap_push_matches_jax_under_tier_sets(graphs, name,
                                                            mode, tiers):
    """PUSHONLY and PUSHPULL structure-only BFS, whose pushes are bitmap
    pushes, equal the JAX bfs (its tier-sized sort push) under each of
    JAX's tier sets and bfs_cpu, from the hub and from vertex 0."""
    from graphblast_tpu.algorithms import bfs as jbfs
    from graphblast_tpu_torch.algorithms import bfs, bfs_cpu

    J, T = graphs[name]
    jdesc = jgb.BFS_TUNED.replace(mxv_mode=getattr(jgb.Direction, mode),
                                  push_tiers=tiers)
    tdesc = tgb.BFS_TUNED.replace(mxv_mode=getattr(tgb.Direction, mode))
    before = tdisp.mxv_dual.bitmap_pushes
    for s in (_hub(T), 0):
        want = np.asarray(jbfs(J, s, jdesc).to_numpy())
        np.testing.assert_array_equal(want, bfs_cpu(T, s))
        np.testing.assert_array_equal(bfs(T, s, tdesc).to_numpy(), want)
    assert tdisp.mxv_dual.bitmap_pushes > before


def test_one_sided_matrix_pushes_and_pushpull_takes_its_direction(graphs):
    """A CSR-only directed Matrix has no CSC, so its vxm (a pull over the
    missing CSC) pushes over the CSR and its mxv (a push over the missing
    CSC) pulls over the CSR, whatever the mode, PUSHPULL too (as
    graphblast_tpu/ops/dispatch.py:201-204 forces it). On the two-sided
    Matrix PUSHPULL equals the JAX PUSHPULL mxv_dual."""
    J, T = graphs["directed"]
    C = tgb.Matrix.from_coo(*T.extract_tuples(), T.nrows, T.ncols,
                            fmt=tgb.SparseFormat.CSRONLY, device="cpu")
    x = np.zeros(T.nrows, np.float32)
    x[[1, 50, 700]] = 1.0
    kw = dict(transpose=True, structure_only=True)
    want, _ = tdisp.mxv_dual(T, _dual(x, 0.0), tgb.LogicalOrAndSemiring, 0.0,
                             mode=tgb.Direction.PULLONLY, **kw)
    for mode in (tgb.Direction.PULLONLY, tgb.Direction.PUSHPULL):
        got, pushed = tdisp.mxv_dual(C, _dual(x, 0.0),
                                     tgb.LogicalOrAndSemiring, 0.0,
                                     mode=mode, **kw)
        assert pushed is True and torch.equal(got.dense, want.dense)
    want_mxv, _ = tdisp.mxv_dual(T, _dual(x, 0.0), tgb.LogicalOrAndSemiring,
                                 0.0, mode=tgb.Direction.PULLONLY,
                                 structure_only=True)
    for mode in (tgb.Direction.PUSHONLY, tgb.Direction.PUSHPULL):
        got, pushed = tdisp.mxv_dual(
            C, tdisp.DualFrontier.from_dense(_t(x), 0.0, prefer_sparse=True),
            tgb.LogicalOrAndSemiring, 0.0, mode=mode, structure_only=True)
        assert pushed is False and torch.equal(got.dense, want_mxv.dense)
    tf, pushed = tdisp.mxv_dual(
        T, tdisp.DualFrontier.from_dense(_t(x), 0.0, prefer_sparse=True),
        tgb.LogicalOrAndSemiring, 0.0, mode=tgb.Direction.PUSHPULL, **kw)
    jf, j_pushed = jdisp.mxv_dual(
        J, jdisp.DualFrontier.from_dense(jnp.asarray(x), 0.0,
                                         prefer_sparse=True),
        jgb.LogicalOrAndSemiring, 0.0, mode=jgb.Direction.PUSHPULL, **kw)
    assert pushed is True and bool(j_pushed)
    assert torch.equal(tf.dense, want.dense)
    _compare_sparse((tf.dense, tf.sind, tf.sval, tf.snvals),
                    (jf.dense, jf.sind, jf.sval, jf.snvals), T.nrows,
                    exact=True)


def test_from_sparse_drops_identity_entries():
    """DualFrontier.from_sparse keeps only non-identity entries, in order,
    so the degree total (over the dense image) and the expansion (over the
    sparse image) count the same edges."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    T = rmat_matrix(8, 8, seed=3, device="cpu")
    n = T.nrows
    deg = np.diff(T.host_csr()[0])
    ids = np.sort(np.random.default_rng(4).choice(np.flatnonzero(deg > 0),
                                                  12, replace=False))
    vals = np.full(12, 2.5, np.float32)
    vals[[1, 4, 5, 11]] = 0.0        # stored entries holding the identity
    ind, val, _ = _frontier(n, ids, vals)
    f = tdisp.DualFrontier.from_sparse(n, _t(ind), _t(val),
                                       torch.tensor(12, dtype=torch.int32),
                                       0.0)
    live = ids[vals != 0]
    assert int(f.snvals) == len(live) == 8
    np.testing.assert_array_equal(f.sind.numpy()[:8], live)
    assert (f.sind.numpy()[8:] == n).all()
    np.testing.assert_array_equal(f.sval.numpy()[:8], 2.5)
    np.testing.assert_array_equal(np.flatnonzero(f.dense.numpy()), live)
    deg_total = int(tdisp._frontier_degree_total(T.row_ptr, f, 0.0))
    total = tpush.expand_frontier(T.row_ptr, T.col_ind, T.val, f.sind,
                                  f.sval, f.snvals, 4096, True,
                                  tgb.LogicalOrAndSemiring, torch.float32)[3]
    assert int(total) == deg_total == int(deg[live].sum())


# ------------------------------------------------------------- BFS, SSSP
ALGO_GRAPHS = ["chesapeake", "grid16", "rmat10"]


def _hub(T):
    return int(np.argmax(np.diff(T.host_csr()[0])))


@pytest.mark.parametrize("variant", ["struct_merge", "values_simple"])
@pytest.mark.parametrize("name", ALGO_GRAPHS)
def test_bfs_pushonly_matches_jax(graphs, name, variant):
    """PUSHONLY BFS, fused and stepped, equal to the JAX PUSHONLY bfs and
    to both goldens: the tuned structure-only MERGE push, and a push over
    the frontier's values with the SIMPLE scatter."""
    from graphblast_tpu.algorithms import bfs as jbfs
    from graphblast_tpu_torch.algorithms import bfs, bfs_cpu

    J, T = graphs[name]
    s = _hub(T)
    extra = (dict(structure_only=False, sort_push=False)
             if variant == "values_simple" else {})
    jdesc = jgb.BFS_TUNED.replace(mxv_mode=jgb.Direction.PUSHONLY, **extra)
    tdesc = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PUSHONLY, **extra)
    want = np.asarray(jbfs(J, s, jdesc).to_numpy())
    np.testing.assert_array_equal(want, bfs_cpu(T, s))
    for mode in ("fused", "stepped"):
        np.testing.assert_array_equal(bfs(T, s, tdesc, mode=mode).to_numpy(),
                                      want, err_msg=mode)


@pytest.mark.parametrize("sort_push", [True, False])
@pytest.mark.parametrize("name", ALGO_GRAPHS)
def test_sssp_pushonly_matches_jax(graphs, name, sort_push):
    """PUSHONLY SSSP, fused and stepped, equal to the JAX PUSHONLY sssp and
    to both goldens: the MERGE push with the sparse filter, and the SIMPLE
    push with the dense filter and the full-n re-sparsification."""
    from graphblast_tpu.algorithms import sssp as jsssp
    from graphblast_tpu_torch.algorithms import sssp, sssp_cpu

    J, T = graphs[name]
    s = _hub(T)
    jdesc = jgb.DEFAULT.replace(mxv_mode=jgb.Direction.PUSHONLY,
                                sort_push=sort_push)
    tdesc = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PUSHONLY,
                                sort_push=sort_push)
    want = np.asarray(jsssp(J, s, jdesc).to_numpy())
    np.testing.assert_array_equal(want, sssp_cpu(T, s))
    for mode in ("fused", "stepped"):
        np.testing.assert_array_equal(
            sssp(T, s, tdesc, mode=mode).to_numpy(), want, err_msg=mode)


def test_stepped_push_rows_say_push(graphs, capsys):
    """The stepped BFS and SSSP rows print push in the used_push column."""
    from graphblast_tpu_torch.algorithms import bfs, sssp

    _, T = graphs["chesapeake"]
    bfs(T, 0, tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PUSHONLY,
                                    timing=1), mode="stepped")
    sssp(T, 0, tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PUSHONLY,
                                   timing=1), mode="stepped")
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) > 2 and all(r.split(", ")[3] == "push" for r in rows)
