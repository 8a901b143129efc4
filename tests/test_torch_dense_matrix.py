"""The port's DenseMatrix, gemm and gemv, and the sparse × dense product
(`ops/spmm.py`, `operations.mxm_dense`) against the JAX package (twins of
tests/test_dense_matrix.py and tests/test_ops.py's spmm case).

The same seeded NumPy arrays go through the JAX functions and the port's
on CPU tensors. Tolerances: containers exactly; min, max and the
comparison folds exactly; plus-times within 1e-5 relative to max|C| (a
matmul's sum order is its library's, and spmm's Plus differences prefix
sums down all the edges, as JAX's does).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops.spmm import spmm as jspmm
from graphblast_tpu_torch.dimension import DimensionException
from graphblast_tpu_torch.ops.spmm import spmm

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")


def _close(got, want, exact: bool):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1))


def test_dense_matrix_container_matches_jax():
    """from_dense, build, from_coo (last wins, plus, and a min fold),
    set_element, extract_element, extract_tuples, fill, fill_ascending,
    clear, resize, transpose, check: the same arrays."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    J = jgb.DenseMatrix.from_dense(a)
    T = tgb.DenseMatrix.from_dense(a, device="cpu")
    assert T.shape == J.shape and T.nvals == J.nvals == 35
    for jm, tm in ((J, T), (J.T, T.T), (J.resize(6, 9), T.resize(6, 9)),
                   (J.resize(2, 2), T.resize(2, 2)),
                   (J.set_element(9.0, 1, 2), T.set_element(9.0, 1, 2)),
                   (J.fill(4.0), T.fill(4.0)), (J.clear(), T.clear()),
                   (J.fill_ascending(10), T.fill_ascending(10)),
                   (J.dup(), T.dup())):
        np.testing.assert_array_equal(tm.to_dense(), np.asarray(
            jm.to_dense()))
        tm.check()
    for x, y in zip(T.extract_tuples(), J.extract_tuples()):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert float(T.extract_element(4, 6)) == float(J.extract_element(4, 6))
    np.testing.assert_array_equal(a, T.to_dense())       # untouched
    flat = np.arange(12, dtype=np.float32)
    np.testing.assert_array_equal(
        tgb.DenseMatrix.build(flat, 3, 4, device="cpu").to_dense(),
        np.asarray(jgb.DenseMatrix.build(flat, 3, 4).to_dense()))
    rows, cols, vals = [0, 0, 2, 0], [1, 1, 3, 1], [2.0, 3.0, 7.0, 1.0]
    for jd, td in ((None, None), (jgb.Plus, tgb.Plus),
                   (jgb.Minimum, tgb.Minimum)):
        np.testing.assert_array_equal(
            tgb.DenseMatrix.from_coo(rows, cols, vals, 3, 4, dup=td,
                                     device="cpu").to_dense(),
            np.asarray(jgb.DenseMatrix.from_coo(rows, cols, vals, 3, 4,
                                                dup=jd).to_dense()))
    with pytest.raises(ValueError, match="logical"):
        tgb.DenseMatrix(3, 3, torch.zeros(2, 3)).check()


GEMM_SEMIRINGS = ["PlusMultipliesSemiring", "MinimumPlusSemiring",
                  "MaximumMultipliesSemiring", "PlusMinusSemiring",
                  "GreaterPlusSemiring", "LogicalOrAndSemiring"]


@pytest.mark.parametrize("semiring", GEMM_SEMIRINGS)
def test_gemm_and_gemv_match_jax(semiring):
    """gemm (a matmul for plus-times, else a fold over k in order) and gemv
    (a matmul, else ⊗ broadcast and a row reduce, a left fold for
    GreaterPlus at k = 6) against JAX's: exact but for plus-times."""
    rng = np.random.default_rng(len(semiring))
    a = rng.integers(-3, 4, (5, 6)).astype(np.float32)
    b = rng.integers(-3, 4, (6, 4)).astype(np.float32)
    x = rng.integers(-3, 4, 6).astype(np.float32)
    exact = semiring != "PlusMultipliesSemiring"
    jA, tA = jgb.DenseMatrix.from_dense(a), tgb.DenseMatrix.from_dense(
        a, device="cpu")
    jB, tB = jgb.DenseMatrix.from_dense(b), tgb.DenseMatrix.from_dense(
        b, device="cpu")
    _close(tgb.gemm(tA, tB, getattr(tgb, semiring)).to_dense(),
           jgb.gemm(jA, jB, getattr(jgb, semiring)).to_dense(), exact)
    _close(tgb.gemv(tA, torch.from_numpy(x), getattr(tgb, semiring)),
           jgb.gemv(jA, x, getattr(jgb, semiring)), exact)
    np.testing.assert_allclose(
        tgb.gemm(tA, tB, tgb.PlusMultipliesSemiring).to_dense(), a @ b,
        rtol=1e-5)


def test_gemm_dim_checks():
    with pytest.raises(DimensionException):
        tgb.gemm(tgb.DenseMatrix.zeros(2, 3, device="cpu"),
                 tgb.DenseMatrix.zeros(4, 2, device="cpu"),
                 tgb.PlusMultipliesSemiring)
    with pytest.raises(DimensionException):
        tgb.gemv(tgb.DenseMatrix.zeros(2, 3, device="cpu"), torch.zeros(5),
                 tgb.PlusMultipliesSemiring)


@pytest.mark.parametrize("semiring", ["PlusMultipliesSemiring",
                                      "MinimumPlusSemiring",
                                      "MaximumMultipliesSemiring",
                                      "PlusMinusSemiring"])
@pytest.mark.parametrize("transpose", [False, True])
def test_mxm_dense_matches_jax(semiring, transpose):
    """mxm_dense over chesapeake and a seeded directed graph with empty rows
    and signed values, B seeded (n × 8), A or Aᵀ: Plus by the prefix-sum
    differences, min and max by the segmented scan, as JAX's spmm."""
    rng = np.random.default_rng(len(semiring) + transpose)
    n = 60
    rows = rng.integers(0, n - 8, 400)
    cols = rng.integers(0, n, 400)
    key = np.unique(rows * n + cols)
    vals = rng.standard_normal(len(key)).astype(np.float32)
    for J, T in ((jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False),
                  tgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False,
                                      device="cpu")),
                 (jgb.Matrix.from_coo(key // n, key % n, vals, n, n),
                  tgb.Matrix.from_coo(key // n, key % n, vals, n, n,
                                      device="cpu"))):
        B = rng.standard_normal((J.ncols, 8)).astype(np.float32)
        jd = jgb.Descriptor(transpose_inp0=transpose)
        td = tgb.Descriptor(transpose_inp0=transpose)
        want = jgb.mxm_dense(J, B, getattr(jgb, semiring), desc=jd)
        for b in (B, tgb.DenseMatrix.from_dense(B, device="cpu")):
            got = tgb.mxm_dense(T, b, getattr(tgb, semiring), desc=td)
            _close(got.numpy(), want,
                   exact=getattr(tgb, semiring).add.name != "PlusMonoid")


def test_spmm_heads_from_the_row_pointers_and_refusals():
    """spmm without row_ind finds min's segment heads from the row pointers
    (JAX's segment_heads); an unsupported ⊕ raises, as in JAX; mxm_dense
    checks B's shape."""
    A = tgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False, device="cpu")
    J = jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False)
    B = np.random.default_rng(2).standard_normal((A.ncols, 3)).astype(
        np.float32)
    got = spmm(A.row_ptr, A.col_ind, A.val, torch.from_numpy(B),
               tgb.MinimumPlusSemiring, A.nrows)
    want = jspmm(J.row_ptr, J.col_ind, J.val, jnp.asarray(B),
                 jgb.MinimumPlusSemiring, J.nrows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="unsupported"):
        spmm(A.row_ptr, A.col_ind, A.val, torch.from_numpy(B),
             tgb.LogicalOrAndSemiring, A.nrows)
    with pytest.raises(ValueError, match="dim mismatch"):
        tgb.mxm_dense(A, B[:5], tgb.PlusMultipliesSemiring)
