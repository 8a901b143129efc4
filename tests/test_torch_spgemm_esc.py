"""The port's unmasked SpGEMM against the JAX package: the ESC (expand,
sort, compress) `spgemm_esc`, its dense route in `spgemm`, and the
unmasked `mxm` (twins of tests/test_ops.py:305-370).

The same seeded scipy matrices build JAX and port Matrices on the CPU,
where the gathers run K6's plain version. Tolerances: min, max and the
logical semirings exactly (the port's stable sort folds each (i, j) in
one fixed order, and min/max/or do not depend on it); float sums within
1e-5 relative to max|C| (JAX's sort is unstable, so its sums add the same
products in another order); pointers and ids exactly. Each case also runs
at max_lanes=512, so that A's entries split into many chunks and the
cross-chunk merge runs.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops import spgemm as jsp
from graphblast_tpu_torch.ops import spgemm as tsp

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")

SEMIRINGS = ["PlusMultipliesSemiring", "MinimumPlusSemiring",
             "MaximumMultipliesSemiring", "LogicalOrAndSemiring",
             "MinimumSelectSecondSemiring", "PlusMinusSemiring"]


def _exact(semiring: str) -> bool:
    return getattr(tgb, semiring).add.name != "PlusMonoid"


def _pair_from_scipy(S, fmt="CSRCSC"):
    c = S.tocoo()
    return (jgb.Matrix.from_coo(c.row, c.col, c.data, *S.shape,
                                fmt=getattr(jgb.SparseFormat, fmt)),
            tgb.Matrix.from_coo(c.row, c.col, c.data, *S.shape,
                                fmt=getattr(tgb.SparseFormat, fmt),
                                device="cpu"))


def _operands(seed=7, m=200, k=300, n=150, density=0.02, negative=False):
    r = np.random.default_rng(seed)
    AS = sp.random(m, k, density=density, random_state=r, format="csr",
                   dtype=np.float32)
    BS = sp.random(k, n, density=density, random_state=r, format="csr",
                   dtype=np.float32)
    if negative:
        AS.data -= 0.5
        BS.data -= 0.5
    return AS, BS


def _same(J, T, exact: bool):
    assert (T.nrows, T.ncols, T.nvals) == (J.nrows, J.ncols, J.nvals)
    assert T.format.name == J.format.name and T.symmetric == J.symmetric
    vals = [np.asarray(J.val)] if J.val is not None else []
    scale = max(float(np.abs(vals[0]).max(initial=0)) if vals else 0, 1.0)
    for leaf in tgb.matrix.LEAVES:
        a, b = getattr(J, leaf), getattr(T, leaf)
        assert (a is None) == (b is None), leaf
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        if leaf.endswith("val") and not exact:
            assert b.dtype == a.dtype
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                       err_msg=leaf)
        else:
            np.testing.assert_array_equal(b, a, err_msg=leaf)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("max_lanes", [1 << 23, 512])
def test_spgemm_esc_matches_jax(semiring, transpose_b, max_lanes):
    """spgemm_esc over A (200 × 300) and B (300 × 150), B or Bᵀ stored,
    with signed values: the same C leaf by leaf as JAX's spgemm_esc."""
    AS, BS = _operands(negative=True)
    JA, TA = _pair_from_scipy(AS)
    JB, TB = _pair_from_scipy(BS.T.tocsr() if transpose_b else BS)
    want = jsp.spgemm_esc(JA, JB, getattr(jgb, semiring),
                          transpose_b=transpose_b, max_lanes=max_lanes)
    got = tsp.spgemm_esc(TA, TB, getattr(tgb, semiring),
                         transpose_b=transpose_b, max_lanes=max_lanes)
    _same(want, got, _exact(semiring))


@pytest.mark.parametrize("max_lanes", [1 << 23, 512])
def test_spgemm_esc_against_scipy(max_lanes):
    """C = A·B equal to scipy's product (1e-5 relative to max|C|), and the
    host sizing: the products and chunks esc_plan cuts them into."""
    AS, BS = _operands()
    _, TA = _pair_from_scipy(AS)
    _, TB = _pair_from_scipy(BS)
    want = (AS @ BS).toarray()
    C = tsp.spgemm_esc(TA, TB, tgb.PlusMultipliesSemiring,
                       max_lanes=max_lanes)
    np.testing.assert_allclose(C.to_dense(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    csum, bounds = tsp.esc_plan(TA, TB, max_lanes=max_lanes)
    a_nnz_col = np.diff(AS.tocsc().indptr)
    b_nnz_row = np.diff(BS.indptr)
    assert csum[-1] == int(a_nnz_col @ b_nnz_row)
    assert bounds[0] == 0 and bounds[-1] == TA.nvals
    assert (len(bounds) - 1 == 1) == (max_lanes >= csum[-1])
    assert all(csum[t] - csum[s] <= max_lanes or t == s + 1
               for s, t in zip(bounds[:-1], bounds[1:]))


def test_spgemm_esc_minplus_over_stored_entries():
    """Min-plus ESC: ⊕ is min over the stored products only, against a
    loop over the entries (tests/test_ops.py's case). Exact."""
    r = np.random.default_rng(3)
    AS = sp.random(60, 50, density=0.1, random_state=r, format="csr",
                   dtype=np.float32)
    BS = sp.random(50, 40, density=0.1, random_state=r, format="csr",
                   dtype=np.float32)
    _, TA = _pair_from_scipy(AS)
    _, TB = _pair_from_scipy(BS)
    want = {}
    Ac = AS.tocoo()
    for i, k, a in zip(Ac.row, Ac.col, Ac.data):
        row = BS.getrow(k).tocoo()
        for j, b in zip(row.col, row.data):
            want[i, j] = min(want.get((i, j), np.inf), np.float32(a + b))
    ci, cj, cv = tsp.spgemm_esc(TA, TB, tgb.MinimumPlusSemiring,
                                max_lanes=512).extract_tuples()
    assert dict(zip(zip(ci.tolist(), cj.tolist()), cv.tolist())) == want


@pytest.mark.parametrize("semiring", SEMIRINGS + ["GreaterPlusSemiring"])
def test_spgemm_dense_route_matches_jax(semiring):
    """Below dense_limit, spgemm multiplies the dense images (absent entries
    are 0, as in JAX's) and builds C with from_dense: JAX's leaves and
    its CSRCSC format."""
    AS, BS = _operands(seed=11, m=40, k=30, n=20, density=0.15,
                       negative=True)
    JA, TA = _pair_from_scipy(AS)
    JB, TB = _pair_from_scipy(BS)
    want = jsp.spgemm(JA, JB, getattr(jgb, semiring))
    got = tsp.spgemm(TA, TB, getattr(tgb, semiring))
    _same(want, got, _exact(semiring))


@pytest.mark.parametrize("dense_limit", [1, 1024 * 1024])
def test_mxm_unmasked_matches_jax(dense_limit, monkeypatch):
    """mxm without a mask: the ESC past dense_limit (here forced with
    dense_limit=1, in both packages) and the dense route below it, on
    chesapeake and with transpose_inp1; equal to scipy's A·A."""
    J = jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False)
    T = tgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False, device="cpu")
    for mod in (jsp, tsp):
        defaults = list(mod.spgemm.__defaults__)
        defaults[-1] = dense_limit
        monkeypatch.setattr(mod.spgemm, "__defaults__", tuple(defaults))
    for desc in ({}, {"transpose_inp1": True}):
        want = jgb.mxm(J, J, jgb.PlusMultipliesSemiring,
                       desc=jgb.Descriptor(**desc))
        got = tgb.mxm(T, T, tgb.PlusMultipliesSemiring,
                      desc=tgb.Descriptor(**desc))
        _same(want, got, exact=True)      # small integer sums: exact
    S = T.to_scipy()
    np.testing.assert_array_equal(got.to_dense(), (S @ S).toarray())


def test_sort_dedup_coo_matches_jax():
    """The ESC's tail on its own: sorted, ⊕-combined, compacted, the
    sentinel rows dropped and padding the tail. Exact for min."""
    rng = np.random.default_rng(19)
    n = 500
    i = rng.integers(0, 20, n).astype(np.int32)
    j = rng.integers(0, 20, n).astype(np.int32)
    i[rng.random(n) < 0.1] = tsp.ROW_SENTINEL
    v = rng.standard_normal(n).astype(np.float32)
    import jax.numpy as jnp

    want = jsp._sort_dedup_coo(jnp.asarray(i), jnp.asarray(j),
                               jnp.asarray(v), jgb.MinimumMonoid,
                               tsp.ROW_SENTINEL)
    got = tsp._sort_dedup_coo(torch.from_numpy(i), torch.from_numpy(j),
                              torch.from_numpy(v), tgb.MinimumMonoid, 20)
    nu = int(want[3])
    assert int(got[3]) == nu
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a[:nu].numpy(), np.asarray(b)[:nu])
    np.testing.assert_array_equal(got[0][nu:].numpy(), tsp.ROW_SENTINEL)


def test_spgemm_esc_empty_and_refusals():
    """An empty product gives an empty C of the right shape; a B without
    the rows the ESC walks raises (JAX recurses without end there); a
    dimension mismatch raises."""
    AS, BS = _operands()
    _, TA = _pair_from_scipy(AS)
    _, TB = _pair_from_scipy(BS)
    Z = tgb.Matrix.from_coo([], [], [], 300, 150, device="cpu")
    C = tsp.spgemm_esc(TA, Z, tgb.PlusMultipliesSemiring)
    assert C.shape == (200, 150) and C.nvals == 0
    with pytest.raises(ValueError, match="B's CSR"):
        tsp.spgemm_esc(TA, TB.set_storage(tgb.SparseFormat.CSCONLY),
                       tgb.PlusMultipliesSemiring)
    with pytest.raises(ValueError, match="dim mismatch"):
        tsp.spgemm_esc(TB, TB, tgb.PlusMultipliesSemiring)
