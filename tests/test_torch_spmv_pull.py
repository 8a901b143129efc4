"""The port's plan-less pull against the JAX package (graphblast_tpu_torch).

The gather K6 and the or-pull prefix count K5 run as their plain PyTorch
versions on CPU tensors and are held to the Pallas kernels in interpret
mode; segops, `spmv_pull` and the plan-less `mxv_dual` are held to the JAX
functions on the same NumPy inputs. Every comparison is exact: gathers and
prefix counts are integer work, and the values are small integers or powers
of two, so every sum and product is exact in any order.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops import segops as jseg
from graphblast_tpu.ops.spmv import spmv_pull as jspmv_pull
from graphblast_tpu_torch.ops import segops as tseg
from graphblast_tpu_torch.ops.gather_dispatch import take
from graphblast_tpu_torch.ops.kernels import gather as kg
from graphblast_tpu_torch.ops.kernels import orpull as ko
from graphblast_tpu_torch.ops.kernels.bitmap_pull import pack_bitmap
from graphblast_tpu_torch.ops.spmv import spmv_pull, spmv_pull_or_fused

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("n,m,sorted_idx,dtype", [
    (128, 9000, False, np.float32),      # a table of one 128-lane row
    (129, 9000, False, np.float32),      # one row and one entry
    (16384, 33000, False, np.float32),   # m not a 32K-chunk multiple
    (16384, 32768, True, np.float32),    # one chunk, sorted
    (1000, 40000, True, np.int32),       # int32 payload, sorted
    (40000, 12, False, np.int32),        # few queries
])
def test_gather_plain_matches_pallas_gather_1d(n, m, sorted_idx, dtype):
    """K6's plain version and `take` vs gather_1d in interpret mode (cases
    of tests/test_pallas.py), the table edges forced into the queries."""
    from graphblast_tpu.ops.pallas.gather import gather_1d

    rng = np.random.default_rng(n + m)
    x = (np.arange(n) * 3 + 1).astype(dtype)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[0], idx[-1] = 0, n - 1
    if sorted_idx:
        idx.sort()
    want = np.asarray(gather_1d(jnp.asarray(x), jnp.asarray(idx),
                                interpret=True))
    got = kg.gather_1d(_t(x), _t(idx))
    assert got.dtype == _t(x).dtype and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kg.gather_1d_plain(_t(x), _t(idx)).numpy(),
                                  want)
    np.testing.assert_array_equal(take(_t(x), _t(idx), sorted=sorted_idx)
                                  .numpy(), want)


@pytest.mark.parametrize("n,m,dtype", [(128, 5000, np.float32),
                                       (4096, 5000, np.int32),
                                       (16384, 100, np.float32)])
def test_gather_plain_matches_pallas_gather_1d_small(n, m, dtype):
    from graphblast_tpu.ops.pallas.gather import gather_1d_small

    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 1000).astype(dtype)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[:2] = [0, n - 1]
    want = np.asarray(gather_1d_small(jnp.asarray(x), jnp.asarray(idx),
                                      interpret=True))
    np.testing.assert_array_equal(kg.gather_1d(_t(x), _t(idx)).numpy(), want)


def test_gather_clamps_and_refuses():
    """Indices clamp into the table, as the JAX off-TPU x[idx] does; the
    wrapper refuses what the kernel does not take."""
    x = torch.arange(5, dtype=torch.float32)
    idx = torch.tensor([-3, 0, 4, 5, 99], dtype=torch.int32)
    np.testing.assert_array_equal(kg.gather_1d(x, idx).numpy(),
                                  [0, 0, 4, 4, 4])
    np.testing.assert_array_equal(take(x, idx.long()).numpy(),
                                  [0, 0, 4, 4, 4])
    # past the end, as the JAX gather clamps there
    np.testing.assert_array_equal(
        kg.gather_1d(x, idx[2:]).numpy(),
        np.asarray(jnp.asarray(x.numpy())[jnp.asarray(idx[2:].numpy())]))
    assert kg.gather_1d(x, idx[:0]).shape == (0,)
    with pytest.raises(ValueError, match="empty table"):
        kg.gather_1d(x[:0], idx)
    with pytest.raises(TypeError):
        kg.gather_1d(x.double(), idx)
    with pytest.raises(TypeError):
        kg.gather_1d(x, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        kg.gather_1d(torch.zeros(10)[::2], idx)


def test_take_routes_by_dtype_and_rank():
    """1-D float32/int32 tables take the kernel's route; other dtypes and
    ranks index plainly, with int64 indices clamped before the cast."""
    x64 = torch.arange(6, dtype=torch.float64)
    idx = torch.tensor([5, 0, 2], dtype=torch.int64)
    np.testing.assert_array_equal(take(x64, idx).numpy(), [5, 0, 2])
    x2 = torch.arange(12, dtype=torch.int32).view(4, 3)
    np.testing.assert_array_equal(take(x2, idx[1:]).numpy(),
                                  x2.numpy()[[0, 2]])
    xi = torch.arange(6, dtype=torch.int32)
    big = torch.tensor([1 << 33, 3], dtype=torch.int64)
    np.testing.assert_array_equal(take(xi, big).numpy(), [5, 3])


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("n,m", [(4096, 70000), (4095, 70000), (50, 257)])
def test_orpull_plain_matches_pallas(n, m):
    """K5's plain version vs orpull_bit_csum in interpret mode (cases of
    tests/test_pallas.py); columns past the bitmap read 0."""
    from graphblast_tpu.ops.pallas.orpull import orpull_bit_csum
    from graphblast_tpu.ops.pallas.orpull import pack_bitmap as jpack

    rng = np.random.default_rng(n + m)
    x = (rng.random(n) < 0.3).astype(np.float32)
    col = rng.integers(0, n, m).astype(np.int32)
    col[:3] = [n - 1, 0, n - 1]
    col[5:9] = [n, n + 31, 32 * ((n + 31) // 32), 1 << 30]
    words = jpack(jnp.asarray(x))
    np.testing.assert_array_equal(pack_bitmap(_t(x)).numpy(),
                                  np.asarray(words))
    want = np.asarray(orpull_bit_csum(words, jnp.asarray(col),
                                      interpret=True))
    got = ko.orpull_bit_csum(pack_bitmap(_t(x)), _t(col))
    assert got.dtype == torch.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.cumsum(np.where(col < n, x[np.minimum(col, n - 1)], 0) != 0)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_orpull_pad_sentinel_reads_zero():
    """n a multiple of 4096, every bit set, every query past the bitmap: the
    Pallas kernel's pad-word case; all counts stay 0."""
    from graphblast_tpu.ops.pallas.orpull import orpull_bit_csum
    from graphblast_tpu.ops.pallas.orpull import pack_bitmap as jpack

    n = 4096
    x = np.ones(n, np.float32)
    col = np.full(300, n, np.int32)
    want = np.asarray(orpull_bit_csum(jpack(jnp.asarray(x)),
                                      jnp.asarray(col), interpret=True))
    got = ko.orpull_bit_csum(pack_bitmap(_t(x)), _t(col))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[-1]) == 0
    # negative columns read 0 too, and no words at all give no bits
    neg = torch.tensor([-1, -32, 0], dtype=torch.int32)
    np.testing.assert_array_equal(
        ko.orpull_bit_csum(pack_bitmap(_t(x)), neg).numpy(), [0, 0, 1])
    np.testing.assert_array_equal(
        ko.orpull_bit_csum(torch.zeros(0, dtype=torch.int32), neg).numpy(),
        [0, 0, 0])


def test_orpull_refuses():
    w = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ko.orpull_bit_csum(w.float(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ko.orpull_bit_csum(w, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ko.orpull_bit_csum(w, torch.zeros(6, dtype=torch.int32)[::2])


# --------------------------------------------------------------- segops
def _csr_with_empty_rows(nrows=60, nnz_pad=1024, seed=11):
    """A CSR whose rows 0, 7..9 and the last are empty, padded past
    row_ptr[nrows] with junk that no row may read."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 30, nrows)
    deg[[0, 7, 8, 9, nrows - 1]] = 0
    ptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    return ptr, nnz_pad


MONOIDS = [m.name for m in tgb.ALL_MONOIDS]


def test_segment_heads_match_jax():
    ptr, nnz_pad = _csr_with_empty_rows()
    want = np.asarray(jseg.segment_heads(jnp.asarray(ptr), nnz_pad))
    np.testing.assert_array_equal(
        tseg.segment_heads(_t(ptr), nnz_pad).numpy(), want)
    # a pointer at nnz_pad (a full edge array) is dropped
    full = np.array([0, 3, 8], np.int32)
    np.testing.assert_array_equal(
        tseg.segment_heads(_t(full), 8).numpy(),
        np.asarray(jseg.segment_heads(jnp.asarray(full), 8)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", MONOIDS)
def test_segmented_scan_and_reduce_match_jax(name, dtype):
    """segmented_scan and segment_reduce_csr of each monoid vs JAX on a CSR
    with empty rows; values in [-2, 2], the padding included."""
    ptr, nnz_pad = _csr_with_empty_rows()
    rng = np.random.default_rng(len(name))
    vals = rng.integers(-2, 3, nnz_pad).astype(dtype)
    jm = getattr(jgb.semiring, name)
    tm = getattr(tgb.semiring, name)
    heads = np.asarray(jseg.segment_heads(jnp.asarray(ptr), nnz_pad))
    want = np.asarray(jseg.segmented_scan(jnp.asarray(vals),
                                          jnp.asarray(heads), jm))
    got = tseg.segmented_scan(_t(vals), _t(heads), tm)
    assert got.dtype == _t(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    nrows = len(ptr) - 1
    want = np.asarray(jseg.segment_reduce_csr(jnp.asarray(vals),
                                              jnp.asarray(ptr), jm, nrows))
    got = tseg.segment_reduce_csr(_t(vals), _t(ptr), tm, nrows)
    assert got.shape == (nrows,) and got.dtype == _t(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_reduce_bool_and_shape():
    """Bool edge values (Plus runs the flag scan there, LogicalOr stays
    bool), int32 sums stay int32, and a row_ptr of the wrong length
    raises."""
    ptr, nnz_pad = _csr_with_empty_rows()
    nrows = len(ptr) - 1
    flags = np.random.default_rng(2).random(nnz_pad) < 0.2
    for name in ("PlusMonoid", "LogicalOrMonoid", "MinimumMonoid"):
        want = np.asarray(jseg.segment_reduce_csr(
            jnp.asarray(flags), jnp.asarray(ptr),
            getattr(jgb.semiring, name), nrows))
        got = tseg.segment_reduce_csr(_t(flags), _t(ptr),
                                      getattr(tgb.semiring, name), nrows)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    ints = torch.ones(nnz_pad, dtype=torch.int32)
    assert tseg.segment_reduce_csr(ints, _t(ptr), tgb.PlusMonoid,
                                   nrows).dtype == torch.int32
    with pytest.raises(ValueError, match="row_ptr"):
        tseg.segment_reduce_csr(ints, _t(ptr), tgb.PlusMonoid, nrows + 1)


# ------------------------------------------------------------ spmv_pull
def _directed(n=300, m=2500, seed=3):
    """A seeded directed graph with integer weights 1..3; vertices 0..9
    have no in-edges and n-20.. no out-edges."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n - 20, m), rng.integers(10, n, m),
            rng.integers(1, 4, m).astype(np.float64), n)


@pytest.fixture(scope="module")
def graphs():
    path = os.path.join(DATA, "chesapeake.mtx")
    rows, cols, vals, n = _directed()
    return {
        "chesapeake": (jgb.Matrix.from_mtx(path, use_cache=False),
                       tgb.Matrix.from_mtx(path, use_cache=False,
                                           device="cpu")),
        "directed": (jgb.Matrix.from_coo(rows, cols, vals, n, n),
                     tgb.Matrix.from_coo(rows, cols, vals, n, n,
                                         device="cpu")),
    }


def _orientation(M, csc):
    if csc:
        return M.col_ptr, M.csc_row_ind, M.csc_val
    return M.row_ptr, M.col_ind, M.val


def _x(name, n, dtype, seed):
    """Frontier values: 0, 1, 2, 4 (no 0 under a division)."""
    rng = np.random.default_rng(seed)
    choices = [1, 2, 4] if "Divides" in name else [0, 1, 2, 4]
    return rng.choice(choices, n).astype(dtype)


PULLS = [("chesapeake", False), ("directed", False), ("directed", True)]


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("graph,csc", PULLS)
@pytest.mark.parametrize("name", [s.name for s in tgb.ALL_SEMIRINGS])
def test_spmv_pull_matches_jax(graphs, name, graph, csc, structure_only):
    """spmv_pull of every semiring of the catalogue vs the JAX spmv_pull
    (its off-TPU path): unmasked, masked and complemented-masked, over the
    CSR and, on the directed graph, the CSC; float32 frontiers."""
    J, T = graphs[graph]
    jarr, tarr = _orientation(J, csc), _orientation(T, csc)
    n = T.ncols if csc else T.nrows
    x = _x(name, T.nrows, np.float32, len(name))
    mask = (np.random.default_rng(5).random(n) < 0.5).astype(np.float32)
    jsr = getattr(jgb.semiring, f"{name}Semiring")
    tsr = getattr(tgb.semiring, f"{name}Semiring")
    for m, scmp in ((None, False), (mask, False), (mask, True)):
        want = np.asarray(jspmv_pull(
            *jarr, jnp.asarray(x), jsr, n,
            mask_dense=None if m is None else jnp.asarray(m),
            mask_scmp=scmp, structure_only=structure_only))
        got = spmv_pull(*tarr, _t(x), tsr, n,
                        mask_dense=None if m is None else _t(m),
                        mask_scmp=scmp, structure_only=structure_only)
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"mask {m is not None}/{scmp}")


@pytest.mark.parametrize("name", ["MaximumMultiplies", "MinimumSelectSecond",
                                  "LogicalOrAnd", "PlusMultiplies",
                                  "MinimumPlus"])
def test_spmv_pull_int32_matches_jax(graphs, name):
    """int32 frontiers, as MIS, colouring and CC pull them: with int32
    values, with MIS's self-mask and unmasked."""
    J, T = graphs["directed"]
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 30, T.nrows).astype(np.int32)
    x[rng.random(T.nrows) < 0.3] = 0
    jsr = getattr(jgb.semiring, f"{name}Semiring")
    tsr = getattr(tgb.semiring, f"{name}Semiring")
    for masked in (True, False):
        want = np.asarray(jspmv_pull(
            J.col_ptr, J.csc_row_ind, J.csc_val.astype(jnp.int32),
            jnp.asarray(x), jsr, T.nrows,
            mask_dense=jnp.asarray(x) if masked else None))
        got = spmv_pull(T.col_ptr, T.csc_row_ind, T.csc_val.to(torch.int32),
                        _t(x), tsr, T.nrows,
                        mask_dense=_t(x) if masked else None)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_spmv_pull_or_fused_matches_jax(graphs):
    from graphblast_tpu.ops.spmv import spmv_pull_or_fused as jfused

    J, T = graphs["directed"]
    x = _x("or", T.nrows, np.float32, 1)
    v = (np.random.default_rng(4).random(T.nrows) < 0.3).astype(np.float32)
    want = np.asarray(jfused(J.col_ptr, J.csc_row_ind, jnp.asarray(x),
                             T.nrows, jnp.asarray(v), True))
    got = spmv_pull_or_fused(T.col_ptr, T.csc_row_ind, _t(x), T.nrows,
                             _t(v), True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < T.nrows


# ------------------------------------------------------------- mxv_dual
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name,structure_only", [
    ("LogicalOrAnd", True), ("LogicalOrAnd", False), ("MinimumPlus", False),
    ("PlusMultiplies", False), ("MaximumMultiplies", False)])
def test_mxv_dual_without_a_plan_matches_jax(graphs, name, structure_only,
                                             transpose):
    """The plan-less PULLONLY mxv_dual vs the JAX mxv_dual with no plan on
    the directed graph, under BFS's complemented mask: equal y and
    nvals."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["directed"]
    jsr = getattr(jgb.semiring, f"{name}Semiring")
    tsr = getattr(tgb.semiring, f"{name}Semiring")
    ident = float(np.asarray(jsr.identity(jnp.float32)))
    x = _x(name, T.nrows, np.float32, 8)
    v = (np.random.default_rng(6).random(T.nrows) < 0.4).astype(np.float32)
    jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(x), ident), jsr, ident,
                 transpose=transpose, mask_dense=jnp.asarray(v),
                 mask_scmp=True, structure_only=structure_only,
                 mode=jgb.Direction.PULLONLY)
    tf, used_push = mxv_dual(T, DualFrontier.from_dense(_t(x), ident), tsr,
                             ident, transpose=transpose, mask_dense=_t(v),
                             mask_scmp=True, structure_only=structure_only,
                             mode=tgb.Direction.PULLONLY)
    assert not used_push
    np.testing.assert_array_equal(tf.dense.numpy(), np.asarray(jf.dense))
    assert int(tf.snvals) == int(jf.snvals) > 0


def test_mxv_dual_without_a_plan_runs_every_mode(graphs):
    """PUSHONLY pushes and gives the plan-less pull's frontier; PUSHPULL
    with the push preferred pushes it too, and with the pull preferred
    pulls it, each equal to the JAX PUSHPULL mxv_dual (dense image, count,
    used_push, use_sparse, ratio)."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["directed"]
    x = torch.zeros(T.nrows)
    x[[3, 40, 41, 290]] = 1.0
    f = DualFrontier.from_dense(x, 0.0)
    kw = dict(transpose=True, structure_only=True)
    pull, _ = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0,
                       mode=tgb.Direction.PULLONLY, **kw)
    push, used_push = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0,
                               mode=tgb.Direction.PUSHONLY, **kw)
    assert used_push and torch.equal(push.dense, pull.dense)
    assert int(push.snvals) == int(pull.snvals) > 0
    for prefer in (True, False):
        got, used_push = mxv_dual(
            T, DualFrontier.from_dense(x, 0.0, prefer_sparse=prefer),
            tgb.LogicalOrAndSemiring, 0.0, mode=tgb.Direction.PUSHPULL, **kw)
        jf, j_push = jmxv(
            J, JFrontier.from_dense(jnp.asarray(x.numpy()), 0.0,
                                    prefer_sparse=prefer),
            jgb.LogicalOrAndSemiring, 0.0, mode=jgb.Direction.PUSHPULL, **kw)
        assert used_push is prefer and bool(j_push) is prefer
        assert torch.equal(got.dense, pull.dense)
        np.testing.assert_array_equal(got.dense.numpy(), np.asarray(jf.dense))
        assert int(got.snvals) == int(jf.snvals) == int(pull.snvals)
        assert bool(got.use_sparse) == bool(jf.use_sparse)
        assert float(got.ratio) == float(jf.ratio)