"""The port's Vector container and the vector half of its operations
surface against the JAX package (graphblast_tpu_torch.operations).

The same NumPy inputs, made from a seed, go through the JAX functions and
the port's on CPU tensors, where each kernel runs its plain version.
Tolerances, stated per test: exact for int32, min, max, logical and the
comparison semirings (their values are computed once, in the same
order); float sums within 1e-5 · max|y| (the pull's cumsum differences
and the push's fold order are the port's own, PR 11's bar); values of a
single float op per lane within 1 ulp (1e-6 relative).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops import elementwise as jew
from graphblast_tpu.ops.segops import reduce_all as jreduce_all
from graphblast_tpu_torch.dimension import DimensionException
from graphblast_tpu_torch.ops import elementwise as tew
from graphblast_tpu_torch.ops.segops import reduce_all, reduce_dim

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")
MAXF = float(np.finfo(np.float32).max)

SEMIRINGS = [s.name for s in tgb.ALL_SEMIRINGS]
# ⊕ that are not associative: the push folds a destination's lanes in its
# sort's order, and JAX's sort is unstable, so only the pull is compared
NON_ASSOCIATIVE = {"GreaterMonoid", "CustomLessMonoid", "NotEqualToMonoid"}


def _sr(pkg, name):
    return getattr(pkg, name + "Semiring")


@pytest.fixture(scope="module")
def graphs():
    """(JAX Matrix, port Matrix): chesapeake, and a seeded directed graph
    with empty rows and values in [0.5, 2)."""
    rng = np.random.default_rng(3)
    n, m = 120, 900
    rows = rng.integers(0, n - 10, m)
    cols = rng.integers(0, n, m)
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.uniform(0.5, 2.0, len(rows)).astype(np.float32)
    return {
        "chesapeake": (jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False),
                       tgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False,
                                           device="cpu")),
        "directed": (jgb.Matrix.from_coo(rows, cols, vals, n, n),
                     tgb.Matrix.from_coo(rows, cols, vals, n, n,
                                         device="cpu")),
    }


def _jv(x):
    return jgb.Vector.dense_from(jnp.asarray(x))


def _tv(x):
    return tgb.Vector.dense_from(np.asarray(x), device="cpu")


def _close(got, want, exact: bool):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want[np.abs(want) < MAXF]).max(initial=0)),
                    1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _exact(semiring_name: str, dtype=np.float32) -> bool:
    add = getattr(tgb, semiring_name + "Semiring").add.name
    return dtype == np.int32 or add not in ("PlusMonoid",
                                            "MultipliesMonoid")


# ------------------------------------------------------------------ Vector
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_vector_constructors_match_jax(dtype):
    """dense_from, full, ascending, sparse_from (its cap and pads), nvals,
    check, set_element, to_sparse, extract_tuples and count_unique: the
    same images, exactly."""
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    x = np.array([0, 3, 0, 2, 2, 0, 5], dtype)
    J, T = _jv(x), _tv(x)
    assert T.n == J.n and T.cap == J.cap
    assert int(T.nvals()) == int(J.nvals())
    assert T.count_unique() == J.count_unique()
    js, ts = J.to_sparse(), T.to_sparse()
    np.testing.assert_array_equal(ts.sind.numpy(), np.asarray(js.sind))
    np.testing.assert_array_equal(ts.sval.numpy(), np.asarray(js.sval))
    assert int(ts.nvals()) == int(js.nvals()) and ts.check(True)
    for a, b in zip(ts.extract_tuples(), js.extract_tuples()):
        np.testing.assert_array_equal(a, np.asarray(b))
    jf = jgb.Vector.full(5, 3, dtype=dtype)
    tf = tgb.Vector.full(5, 3, dtype=tdt, device="cpu")
    np.testing.assert_array_equal(tf.to_numpy(), np.asarray(jf.to_numpy()))
    np.testing.assert_array_equal(
        tgb.Vector.ascending(6, device="cpu").to_numpy(),
        np.asarray(jgb.Vector.ascending(6).to_numpy()))
    jsp = jgb.Vector.sparse_from(10, [2, 5, 7], [1, 2, 3], dtype=dtype, cap=6)
    tsp = tgb.Vector.sparse_from(10, [2, 5, 7], [1, 2, 3], dtype=tdt, cap=6,
                                 device="cpu")
    assert tsp.cap == jsp.cap == 6
    for leaf in ("sind", "sval", "snvals"):
        np.testing.assert_array_equal(getattr(tsp, leaf).numpy(),
                                      np.asarray(getattr(jsp, leaf)))
    for jv, tv in ((jsp, tsp), (J, T)):
        jv2, tv2 = jv.set_element(9, 4), tv.set_element(9, 4)
        np.testing.assert_array_equal(tv2.to_numpy(),
                                      np.asarray(jv2.to_numpy()))
        assert int(tv2.nvals()) == int(jv2.nvals())
    np.testing.assert_array_equal(T.to_numpy(), x)        # untouched
    assert tsp.check(expect_sorted=True) and tsp.set_element(9, 4).check()


def test_vector_check_raises_on_broken_images():
    v = tgb.Vector.sparse_from(8, [1, 6], [1.0, 2.0], device="cpu")
    bad = tgb.Vector(8, tgb.Storage.SPARSE, sind=torch.tensor(
        [6, 1, 8, 8, 8, 8, 8, 8], dtype=torch.int32), sval=v.sval,
        snvals=torch.tensor(2, dtype=torch.int32))
    assert bad.check()
    with pytest.raises(ValueError, match="ascending"):
        bad.check(expect_sorted=True)
    with pytest.raises(ValueError, match="pad sentinel"):
        tgb.Vector(8, tgb.Storage.SPARSE, sind=bad.sind, sval=v.sval,
                   snvals=torch.tensor(1, dtype=torch.int32)).check()


def test_jax_state_carries_across_unchanged():
    """A JAX Vector (dense and padded sparse, via np.asarray of its fields)
    and a JAX Matrix (its leaves and its format, here CSRONLY after
    set_storage on a symmetric graph) handed to the port give the same
    images, and the same mxv."""
    J = jgb.Matrix.from_mtx(CHESAPEAKE, use_cache=False).set_storage(
        jgb.SparseFormat.CSRONLY)
    T = tgb.Matrix.from_numpy_arrays(
        {k: None if getattr(J, k) is None else np.asarray(getattr(J, k))
         for k in tgb.matrix.LEAVES}, J.nrows, J.ncols, J.nvals,
        J.symmetric, device="cpu", fmt=tgb.SparseFormat[J.format.name])
    assert T.format == tgb.SparseFormat.CSRONLY and T.col_ptr is None
    rng = np.random.default_rng(4)
    x = (rng.random(J.ncols) < 0.3) * rng.random(J.ncols)
    ju = jgb.Vector.dense_from(jnp.asarray(x, jnp.float32)).to_sparse(0)
    tu = tgb.Vector.sparse_from(ju.n, np.asarray(ju.sind),
                                np.asarray(ju.sval),
                                nvals=int(ju.snvals), device="cpu")
    for leaf in ("sind", "sval", "snvals"):
        np.testing.assert_array_equal(getattr(tu, leaf).numpy(),
                                      np.asarray(getattr(ju, leaf)))
    jy = jgb.mxv(J, ju, jgb.MinimumPlusSemiring)
    ty = tgb.mxv(T, tu, tgb.MinimumPlusSemiring)
    np.testing.assert_array_equal(ty.to_numpy(MAXF),
                                  np.asarray(jy.to_numpy(MAXF)))
    td = tgb.Vector.dense_from(np.asarray(ju.to_dense(0).dense),
                               device="cpu")
    assert td.storage == tgb.Storage.DENSE and td.device.type == "cpu"


def test_vector_dense_from_keeps_a_tensors_device():
    t = torch.arange(4.0)
    assert tgb.Vector.dense_from(t).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tgb.Vector.dense_from(np.arange(4.0))


# ------------------------------------------------------------ reduce_all
@pytest.mark.parametrize("monoid", [m.name for m in tgb.ALL_MONOIDS])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_all_matches_jax(monoid, dtype):
    """reduce_all over every monoid, at every length of 1 to 32, where the
    JAX CPU reduce is a left fold: exact for all but the float sum and
    product (1e-5 relative)."""
    rng = np.random.default_rng(len(monoid))
    for n in range(1, 33):
        x = rng.integers(-2, 3, n).astype(dtype)
        if dtype == np.float32:
            x = x * np.float32(0.75)
        want = np.asarray(jreduce_all(jnp.asarray(x), getattr(jgb, monoid)))
        got = reduce_all(torch.from_numpy(x), getattr(tgb, monoid)).numpy()
        assert got.dtype == want.dtype, (monoid, n)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                   err_msg=f"{monoid} n={n}")


@pytest.mark.parametrize("monoid", ["GreaterMonoid", "CustomLessMonoid",
                                    "NotEqualToMonoid", "LogicalAndMonoid"])
@pytest.mark.parametrize("n", [33, 1000, 4097])
def test_reduce_all_is_a_left_fold(monoid, n):
    """Past 32 elements the JAX CPU reduce reassociates, so the fold is
    held to a Python left fold from the identity, one element at a time,
    along a dim too (`reduce_dim`)."""
    m = getattr(tgb, monoid)
    rng = np.random.default_rng(n)
    x = rng.integers(0, 3, (3, n)).astype(np.float32)
    ident = m.identity(torch.float32)
    for row in range(3):
        acc = ident
        for v in torch.from_numpy(x[row]):
            acc = m(acc, v)
        assert float(reduce_all(torch.from_numpy(x[row]), m)) == float(acc)
        assert float(reduce_dim(torch.from_numpy(x), m, 1)[row]) == float(acc)


# ------------------------------------------------------------ mxv / vxm
def _inputs(J, seed, dtype, sparse):
    rng = np.random.default_rng(seed)
    n = J.ncols
    x = (rng.integers(1, 8, n) * (0.5 if dtype == np.float32 else 1))
    x = np.where(rng.random(n) < 0.5, 0, x).astype(dtype)
    m = (rng.random(J.nrows) < 0.5).astype(np.float32)
    w = rng.integers(0, 4, J.nrows).astype(dtype)
    return x, m, w


def _matvec(pkg, fn, A, x, m, w, semiring, desc, sparse):
    u = pkg.Vector.dense_from(x) if pkg is jgb else pkg.Vector.dense_from(
        x, device="cpu")
    if sparse:
        u = u.to_sparse(0)
    mv = (pkg.Vector.dense_from(m) if pkg is jgb
          else pkg.Vector.dense_from(m, device="cpu"))
    wv = (pkg.Vector.dense_from(w) if pkg is jgb
          else pkg.Vector.dense_from(w, device="cpu"))
    args = (A, u) if fn == "mxv" else (u, A)
    return getattr(pkg, fn)(*args, semiring, mask=mv, accum=pkg.PlusMonoid,
                            desc=desc, w=wv)


# the push of a non-associative ⊕ folds a destination's lanes in its
# sort's order, so it has no case here
MATVEC_CASES = [(s, d) for s in SEMIRINGS for d in ("PULLONLY", "PUSHONLY")
                if d == "PULLONLY"
                or getattr(tgb, s + "Semiring").add.name not in NON_ASSOCIATIVE]


@pytest.mark.parametrize("semiring,direction", MATVEC_CASES)
@pytest.mark.parametrize("fn", ["mxv", "vxm"])
def test_matvec_every_semiring_matches_jax(graphs, semiring, direction, fn):
    """mxv and vxm over the directed graph with a complemented mask, a Plus
    accumulator and w, pull and push, each semiring of the catalog: the
    same storage and values (exact, or 1e-5·max|y| for float sums)."""
    J, T = graphs["directed"]
    x, m, w = _inputs(J, len(semiring), np.float32, False)
    jd = jgb.Descriptor(mxv_mode=getattr(jgb.Direction, direction),
                        mask_scmp=True)
    td = tgb.Descriptor(mxv_mode=getattr(tgb.Direction, direction),
                        mask_scmp=True)
    jy = _matvec(jgb, fn, J, x, m, w, _sr(jgb, semiring), jd, False)
    ty = _matvec(tgb, fn, T, x, m, w, _sr(tgb, semiring), td, False)
    assert ty.storage.name == jy.storage.name
    ident = float(_sr(jgb, semiring).identity(jnp.float32))
    _close(ty.to_numpy(ident), jy.to_numpy(ident), _exact(semiring))


@pytest.mark.parametrize("semiring", ["MinimumPlus", "PlusMultiplies",
                                      "MaximumMultiplies", "LogicalOrAnd"])
@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHONLY", "PUSHPULL"])
def test_matvec_int32_and_storage_dispatch(graphs, semiring, mode):
    """int32 frontiers (exact) over chesapeake, mxv and vxm, and the
    PUSHPULL storage dispatch: a sparse u pushes and gives a sparse w."""
    J, T = graphs["chesapeake"]
    x, m, w = _inputs(J, 7, np.int32, False)
    for fn in ("mxv", "vxm"):
        for sparse in (False, True):
            jd = jgb.Descriptor(mxv_mode=getattr(jgb.Direction, mode))
            td = tgb.Descriptor(mxv_mode=getattr(tgb.Direction, mode))
            jy = _matvec(jgb, fn, J, x, m, w, _sr(jgb, semiring), jd, sparse)
            ty = _matvec(tgb, fn, T, x, m, w, _sr(tgb, semiring), td, sparse)
            assert ty.storage.name == jy.storage.name
            ident = int(_sr(jgb, semiring).identity(jnp.int32))
            _close(ty.to_numpy(ident), jy.to_numpy(ident), True)


@pytest.mark.parametrize("fmt", ["CSRONLY", "CSCONLY"])
@pytest.mark.parametrize("fn", ["mxv", "vxm"])
def test_matvec_one_sided_matrix_forces_its_direction(graphs, fmt, fn):
    """A Matrix with one orientation pulls or pushes over it, whatever u's
    storage: the same storage and values as the JAX package (MinimumPlus,
    exact)."""
    J0, _ = graphs["directed"]
    r, c, v = J0.extract_tuples()
    J = jgb.Matrix.from_coo(r, c, v, J0.nrows, J0.ncols,
                            fmt=getattr(jgb.SparseFormat, fmt))
    T = tgb.Matrix.from_coo(r, c, v, J0.nrows, J0.ncols,
                            fmt=getattr(tgb.SparseFormat, fmt), device="cpu")
    x, m, w = _inputs(J, 11, np.float32, False)
    for sparse in (False, True):
        jy = _matvec(jgb, fn, J, x, m, w, jgb.MinimumPlusSemiring,
                     jgb.DEFAULT, sparse)
        ty = _matvec(tgb, fn, T, x, m, w, tgb.MinimumPlusSemiring,
                     tgb.DEFAULT, sparse)
        assert ty.storage.name == jy.storage.name
        _close(ty.to_numpy(MAXF), jy.to_numpy(MAXF), True)


@pytest.mark.parametrize("direction", ["PULLONLY", "PUSHONLY"])
def test_structure_only_or_pull_and_push(graphs, direction):
    """The BFS idiom: LogicalOrAnd, structure_only, complemented mask; on
    the pull this is the prefix-count route (K5 + K6). Exact."""
    J, T = graphs["chesapeake"]
    rng = np.random.default_rng(5)
    x = (rng.random(J.ncols) < 0.3).astype(np.float32)
    m = (rng.random(J.nrows) < 0.5).astype(np.float32)
    jd = jgb.Descriptor(mask_scmp=True, structure_only=True,
                        mxv_mode=getattr(jgb.Direction, direction))
    td = tgb.Descriptor(mask_scmp=True, structure_only=True,
                        mxv_mode=getattr(tgb.Direction, direction))
    jy = jgb.mxv(J, _jv(x), jgb.LogicalOrAndSemiring, mask=_jv(m), desc=jd)
    ty = tgb.mxv(T, _tv(x), tgb.LogicalOrAndSemiring, mask=_tv(m), desc=td)
    _close(ty.to_numpy(), jy.to_numpy(), True)


def test_apply_vxm_is_vxm_with_its_accumulator(graphs):
    J, T = graphs["directed"]
    rng = np.random.default_rng(6)
    x = rng.random(J.nrows).astype(np.float32)
    w = rng.random(J.ncols).astype(np.float32)
    jy = jgb.apply_vxm(_jv(x), J, jgb.PlusMultipliesSemiring,
                       accum=jgb.PlusMonoid, w=_jv(w))
    ty = tgb.apply_vxm(_tv(x), T, tgb.PlusMultipliesSemiring,
                       accum=tgb.PlusMonoid, w=_tv(w))
    _close(ty.to_numpy(), jy.to_numpy(), False)
    tz = tgb.vxm(_tv(x), T, tgb.PlusMultipliesSemiring, accum=tgb.PlusMonoid,
                 w=_tv(w))
    np.testing.assert_array_equal(ty.to_numpy(), tz.to_numpy())


def test_matvec_checks_dimensions(graphs):
    _, T = graphs["directed"]
    short = _tv(np.zeros(T.ncols - 1, np.float32))
    with pytest.raises(DimensionException, match="mxv"):
        tgb.mxv(T, short, tgb.PlusMultipliesSemiring)
    with pytest.raises(DimensionException, match="vxm"):
        tgb.vxm(_tv(np.zeros(T.nrows, np.float32)), T,
                tgb.PlusMultipliesSemiring, mask=short)


def test_debug_prints_the_banner(graphs, capsys):
    _, T = graphs["chesapeake"]
    tgb.mxv(T, tgb.Vector.full(T.ncols, 1.0, device="cpu"),
            tgb.PlusMultipliesSemiring, desc=tgb.Descriptor(debug=True))
    out = capsys.readouterr().out
    assert "===Begin mxv===" in out and "mxvmode=" in out


# ------------------------------------------------------------ eWise
EWISE_OPS = ["PlusMultipliesSemiring", "MinimumPlusSemiring",
             "PlusMinusSemiring", "CustomLessPlusSemiring",
             "PlusDividesSemiring", "Plus", "Minimum", "MinimumMonoid"]


def _ewise_inputs(seed, n=40):
    rng = np.random.default_rng(seed)
    u = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 9, n)).astype(
        np.float32)
    v = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 9, n)).astype(
        np.float32)
    m = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.integers(0, 5, n).astype(np.float32)
    return u, v, m, w


@pytest.mark.parametrize("op", EWISE_OPS)
@pytest.mark.parametrize("fn", ["eWiseMult", "eWiseAdd"])
@pytest.mark.parametrize("case", ["dense", "sparse_dense", "sparse_sparse",
                                  "scalar", "masked_scmp", "accum"])
def test_ewise_matches_jax(op, fn, case):
    """eWiseMult (⊗) and eWiseAdd (⊕) over dense and sparse operands, a
    scalar v, a complemented mask and an accumulator, with the
    reference's quirks (a Semiring's annihilator, eWiseMult's ignored
    scmp, sparse ∘ dense eWiseMult keeping u's sparsity): the same
    storage and values, each one float op a lane (1e-6 relative)."""
    u, v, m, w = _ewise_inputs(len(op) + len(case))
    ju, tu = _jv(u), _tv(u)
    jv, tv = _jv(v), _tv(v)
    kw_j, kw_t = {}, {}
    if case in ("sparse_dense", "sparse_sparse"):
        ju, tu = ju.to_sparse(0), tu.to_sparse(0)
    if case == "sparse_sparse":
        jv, tv = jv.to_sparse(0), tv.to_sparse(0)
    if case == "scalar":
        jv = tv = 3.0
    if case == "masked_scmp":
        kw_j = dict(mask=_jv(m), desc=jgb.Descriptor(mask_scmp=True))
        kw_t = dict(mask=_tv(m), desc=tgb.Descriptor(mask_scmp=True))
    if case == "accum":
        kw_j = dict(accum=jgb.Plus, w=_jv(w))
        kw_t = dict(accum=tgb.Plus, w=_tv(w))
    jy = getattr(jgb, fn)(ju, jv, getattr(jgb, op), **kw_j)
    ty = getattr(tgb, fn)(tu, tv, getattr(tgb, op), **kw_t)
    assert ty.storage.name == jy.storage.name
    got, want = ty.to_numpy(), np.asarray(jy.to_numpy())
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------ apply
@pytest.mark.parametrize("backend", ["device", "cpu"])
@pytest.mark.parametrize("masked", [False, True])
def test_apply_matches_jax(backend, masked):
    """w = fn(u), fn a tensor function (device) or one on Python numbers
    (the host-functor backend); where the mask fails, u's old value.
    Exact."""
    u, _, m, _ = _ewise_inputs(21)
    jdesc = jgb.Descriptor(mask_scmp=masked,
                           backend="cpu" if backend == "cpu" else "tpu")
    tdesc = tgb.Descriptor(mask_scmp=masked, backend=backend)
    jm, tm = (_jv(m), _tv(m)) if masked else (None, None)
    fn = (lambda a: a * 2 + 1)
    jy = jgb.apply(_jv(u), fn, mask=jm, desc=jdesc)
    ty = tgb.apply(_tv(u), fn, mask=tm, desc=tdesc)
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))


# ------------------------------------------------------------ assign
@pytest.mark.parametrize("case", ["dense_masked", "dense_scmp", "replace",
                                  "unmasked", "sparse_prune",
                                  "sparse_unmasked"])
def test_assign_matches_jax(case):
    """Masked constant assign: a dense w keeps its old values where the
    mask fails (or clears them with output_replace); a sparse w sets, then
    prunes the entries equal to the value, SSSP's filter. Exact."""
    rng = np.random.default_rng(len(case))
    n = 24
    w = rng.integers(1, 6, n).astype(np.float32)
    m = (rng.random(n) < 0.5).astype(np.float32)
    scmp = case in ("dense_scmp", "sparse_prune")
    jdesc = jgb.Descriptor(mask_scmp=scmp, output_replace=case == "replace")
    tdesc = tgb.Descriptor(mask_scmp=scmp, output_replace=case == "replace")
    jm, tm = (None, None) if "unmasked" in case else (_jv(m), _tv(m))
    jw, tw = _jv(w), _tv(w)
    if case.startswith("sparse"):
        ind = np.sort(rng.choice(n, 9, replace=False))
        jw = jgb.Vector.sparse_from(n, ind, w[ind])
        tw = tgb.Vector.sparse_from(n, ind, w[ind], device="cpu")
    jy = jgb.assign(jw, MAXF, mask=jm, desc=jdesc)
    ty = tgb.assign(tw, MAXF, mask=tm, desc=tdesc)
    assert ty.storage.name == jy.storage.name
    if ty.storage == tgb.Storage.SPARSE:
        for leaf in ("sind", "sval", "snvals"):
            np.testing.assert_array_equal(getattr(ty, leaf).numpy(),
                                          np.asarray(getattr(jy, leaf)))
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))


def test_assign_indexed_scatter_gather_match_jax():
    """assign_indexed, scatter (dense and sparse ids, with ids past the
    end and negative ones, which JAX's drop-mode scatter wraps or drops),
    assign_scatter (unique ids) and extract_gather: exact."""
    rng = np.random.default_rng(13)
    n = 16
    w = rng.integers(0, 9, n).astype(np.float32)
    u = rng.integers(0, 9, n).astype(np.float32)
    jy = jgb.assign_indexed(_jv(w), _jv(u[:4]), [3, 0, 15, 7])
    ty = tgb.assign_indexed(_tv(w), _tv(u[:4]), [3, 0, 15, 7])
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))
    ids = np.array([2, 5, 17, -1, -16, -40, 5, 9], np.int32)
    for ji, ti in ((_jv(ids), _tv(ids)),
                   (jgb.Vector.sparse_from(n, [1, 4, 11], [1.0, 1.0, 1.0]),
                    tgb.Vector.sparse_from(n, [1, 4, 11], [1.0, 1.0, 1.0],
                                           device="cpu"))):
        jy = jgb.scatter(_jv(w), ji, 7.0)
        ty = tgb.scatter(_tv(w), ti, 7.0)
        np.testing.assert_array_equal(ty.to_numpy(),
                                      np.asarray(jy.to_numpy()))
    perm = rng.permutation(n).astype(np.int32)
    jy = jgb.assign_scatter(_jv(w), _jv(u), _jv(perm))
    ty = tgb.assign_scatter(_tv(w), _tv(u), _tv(perm))
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))
    idx = rng.integers(-3, n + 3, n).astype(np.int32)
    jy = jgb.extract_gather(_jv(u), _jv(idx))
    ty = tgb.extract_gather(_tv(u), _tv(idx))
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))


# ------------------------------------------------------------ reduce
@pytest.mark.parametrize("monoid", [m.name for m in tgb.ALL_MONOIDS])
@pytest.mark.parametrize("storage", ["dense", "sparse", "struconly"])
def test_reduce_vector_matches_jax(monoid, storage):
    """vector → scalar over 24 lanes (a left fold for the non-associative
    monoids, as JAX's CPU reduce at that length): exact, 1e-6 relative for
    the float sum and product."""
    rng = np.random.default_rng(len(monoid))
    x = (rng.integers(1, 4, 24) * 0.5).astype(np.float32)
    if storage == "dense":
        ju, tu = _jv(x), _tv(x)
    else:
        ind = np.sort(rng.choice(24, 7, replace=False))
        ju = jgb.Vector.sparse_from(24, ind, x[ind], cap=12)
        tu = tgb.Vector.sparse_from(24, ind, x[ind], cap=12, device="cpu")
    jd = jgb.Descriptor(structure_only=storage == "struconly")
    td = tgb.Descriptor(structure_only=storage == "struconly")
    want = np.asarray(jgb.reduce_vector(ju, getattr(jgb, monoid), desc=jd))
    got = tgb.reduce_vector(tu, getattr(tgb, monoid), desc=td).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------ extract, scale
def test_extract_vector_matches_jax():
    """extract with repeated ids, GrB_ALL, a mask with an accumulator into
    w, and its bound checks (twins of tests/test_extract.py). Exact."""
    u = np.arange(10, dtype=np.float32)
    for idx in ([7, 2, 2, 9], None):
        np.testing.assert_array_equal(
            tgb.extract(_tv(u), idx).to_numpy(),
            np.asarray(jgb.extract(_jv(u), idx).to_numpy()))
    base = np.full(3, 100, np.float32)
    mask = np.asarray([1, 0, 1], np.float32)
    for scmp in (False, True):
        jy = jgb.extract(_jv(u), [4, 5, 6], mask=_jv(mask), accum=jgb.Plus,
                         w=_jv(base), desc=jgb.Descriptor(mask_scmp=scmp))
        ty = tgb.extract(_tv(u), [4, 5, 6], mask=_tv(mask), accum=tgb.Plus,
                         w=_tv(base), desc=tgb.Descriptor(mask_scmp=scmp))
        np.testing.assert_array_equal(ty.to_numpy(),
                                      np.asarray(jy.to_numpy()))
    with pytest.raises(DimensionException):
        tgb.extract(_tv(u[:4]), [0, 4])
    with pytest.raises(DimensionException):
        tgb.extract(_tv(u[:4]), [0, 1], mask=tgb.Vector.full(3, 1.0,
                                                           device="cpu"))


@pytest.mark.parametrize("op", ["Multiplies", "Plus", "PlusMinusSemiring"])
def test_scale_vector_matches_jax(op):
    u = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(
        tgb.scale_vector(_tv(u), getattr(tgb, op), 2.5).to_numpy(),
        np.asarray(jgb.scale_vector(_jv(u), getattr(jgb, op),
                                    2.5).to_numpy()))
    js = jgb.Vector.sparse_from(8, [1, 4], [3.0, 5.0])
    ts = tgb.Vector.sparse_from(8, [1, 4], [3.0, 5.0], device="cpu")
    jy = jgb.scale_vector(js, getattr(jgb, op), 10.0)
    ty = tgb.scale_vector(ts, getattr(tgb, op), 10.0)
    assert ty.storage == tgb.Storage.SPARSE
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy.to_numpy()))


# ------------------------------------------------- ops/elementwise.py
def test_elementwise_functions_match_jax():
    """The eleven array-level functions of ops/elementwise.py on the same
    arrays: exact (each is one op a lane, a scatter or a gather)."""
    rng = np.random.default_rng(17)
    n = 20
    u = rng.integers(0, 6, n).astype(np.float32)
    v = rng.integers(0, 6, n).astype(np.float32)
    m = (rng.random(n) < 0.5).astype(np.float32)
    sind = np.concatenate([np.sort(rng.choice(n, 6, replace=False)),
                           np.full(4, n)]).astype(np.int32)
    sval = rng.integers(1, 5, 10).astype(np.float32)
    idx = rng.integers(-2, n + 2, 12).astype(np.int32)
    ptr = np.array([0, 3, 3, 7, 12, 20], np.int32)
    nv = np.asarray(6, np.int32)
    J, T = jnp.asarray, torch.from_numpy
    cases = [
        ("ewise_binary_dense", (u, v, "Minus", 0, m, True)),
        ("ewise_binary_dense", (u, 2.0, "Divides", 9, None, False)),
        ("ewise_add_sparse_dense", (n, sind, sval, nv, v, "Minimum")),
        ("apply_unary_dense", (u, lambda a: a * 3 - 1, m, False)),
        ("assign_constant_dense", (u, 4.0, m, True)),
        ("assign_constant_dense", (u, 4.0, None, False)),
        ("assign_constant_sparse", (n, sind, sval, nv, 2.0, m, False)),
        ("scatter_indexed", (u, v[:12], idx)),
        ("gather_indexed", (u, idx)),
        ("scatter_constant", (u, 8.0, idx)),
        ("reduce_dense_vector", (u, "MinimumMonoid")),
        ("reduce_sparse_vector", (sval, nv, "PlusMonoid", False)),
        ("reduce_sparse_vector", (sval, nv, "PlusMonoid", True)),
        ("reduce_matrix_rows", (ptr, u, "MaximumMonoid", 5)),
    ]
    for name, args in cases:
        def conv(pkg, a, wrap):
            if isinstance(a, np.ndarray):
                return wrap(a.copy())
            if isinstance(a, str):
                return getattr(pkg, a)
            return a
        want = getattr(jew, name)(*(conv(jgb, a, J) for a in args))
        got = getattr(tew, name)(*(conv(tgb, a, T) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                          err_msg=name)
