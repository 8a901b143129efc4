"""The port's PageRank slice against the JAX package (graphblast_tpu_torch).

The same graphs, loaded from data/small or made with NumPy from a seed, go
through the JAX functions and the port's on CPU tensors, where the value
pull runs as its plain PyTorch version. Tolerances, stated per test:
structure arrays are compared exactly; scaled values within 1e-6 (both
compute them in float32); value pulls within 1e-5 * max|y|, the bar of
tests/test_pallas.py; ranks at rtol 1e-3 / atol 1e-6 against the JAX `pr`,
as tests/test_algorithms.py holds the JAX `pr` to its golden.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import pr as jax_pr
from graphblast_tpu.algorithms import pr_cpu as jax_pr_cpu
from graphblast_tpu_torch.algorithms import pr, pr_cpu, prepare_pr_matrix
from graphblast_tpu_torch.ops.kernels import value_pull as vp

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MAXF32 = float(np.finfo(np.float32).max)
LEAVES = ("row_ptr", "col_ind", "row_ind", "val", "col_ptr", "csc_row_ind",
          "csc_col_ind", "csc_val")


def _directed(weighted: bool, n=300, m=2500, seed=3):
    """A seeded directed graph with empty rows (vertices n-20.. have no
    out-edges) and, when `weighted`, values in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n - 20, m)
    cols = rng.integers(0, n, m)
    vals = rng.uniform(0.5, 2.0, m) if weighted else np.ones(m)
    return rows, cols, vals, n


def _graphs(name):
    """(JAX Matrix, port Matrix) for one named test graph."""
    if name in ("test_pr", "chesapeake"):
        path = os.path.join(DATA, f"{name}.mtx")
        return (jgb.Matrix.from_mtx(path, use_cache=False),
                tgb.Matrix.from_mtx(path, use_cache=False, device="cpu"))
    rows, cols, vals, n = _directed(weighted=name == "weighted")
    return (jgb.Matrix.from_coo(rows, cols, vals, n, n),
            tgb.Matrix.from_coo(rows, cols, vals, n, n, device="cpu"))


GRAPHS = ["test_pr", "chesapeake", "directed", "weighted"]


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _assert_same_matrix(J, T, rtol=1e-6):
    assert (T.nrows, T.ncols, T.nvals) == (J.nrows, J.ncols, J.nvals)
    assert T.symmetric == J.symmetric
    for k in LEAVES:
        a, b = getattr(J, k), getattr(T, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        if k.endswith("val"):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=k)


# ------------------------------------------------------------ operations
def _plus_reduce_atol(T):
    """The JAX row sum is the difference of two float32 prefix sums over all
    edges (segops.segment_reduce_csr), so it is exact only to a few ulps of
    the total: 4 * 2^-23 * sum|val|."""
    return 4 * 2.0 ** -23 * float(np.abs(T.host_csr()[2]).sum())


@pytest.mark.parametrize("name", GRAPHS)
def test_pr_matrix_prep_matches_jax(graphs, name):
    """reduce_matrix_to_vector, eWiseMult_matrix_scalar and
    scale_matrix_rows, and prepare_pr_matrix, which composes them: the same
    arrays, values within 1e-6 relative. The row sums are also held to a
    float64 golden (rtol 1e-6), and to the JAX sums within their own
    rounding (_plus_reduce_atol); scale_matrix_rows gets the JAX sums, so
    that it is compared alone."""
    from graphblast_tpu import operations as jops
    from graphblast_tpu.algorithms.pr import prepare_pr_matrix as jprep

    J, T = graphs[name]
    ptr, _, vals = T.host_csr()
    gold = np.bincount(np.repeat(np.arange(T.nrows), np.diff(ptr)),
                       weights=vals.astype(np.float64), minlength=T.nrows)
    jdeg = jops.reduce_matrix_to_vector(J, jgb.PlusMonoid)
    tdeg = tgb.reduce_matrix_to_vector(T, tgb.PlusMonoid)
    np.testing.assert_allclose(tdeg.to_numpy(), gold, rtol=1e-6)
    np.testing.assert_allclose(tdeg.to_numpy(), np.asarray(jdeg.to_numpy()),
                               rtol=0, atol=_plus_reduce_atol(T))
    jscaled = jops.eWiseMult_matrix_scalar(J, jgb.PlusMultipliesSemiring,
                                           0.85)
    tscaled = tgb.eWiseMult_matrix_scalar(T, tgb.PlusMultipliesSemiring,
                                          0.85)
    _assert_same_matrix(jscaled, tscaled)
    jrows = jops.scale_matrix_rows(jscaled, jdeg, jgb.PlusDividesSemiring)
    same_deg = tgb.Vector(T.nrows, tgb.Storage.DENSE, dense=torch.from_numpy(
        np.array(jdeg.to_numpy())))
    trows = tgb.scale_matrix_rows(tscaled, same_deg, tgb.PlusDividesSemiring)
    assert not trows.symmetric      # the result keeps its own CSC
    _assert_same_matrix(jrows, trows)
    if np.all(vals == 1):           # unit values: the row sums are exact
        _assert_same_matrix(jprep(J, 0.85), prepare_pr_matrix(T, 0.85))


@pytest.mark.parametrize("monoid", ["PlusMonoid", "MinimumMonoid",
                                    "MaximumMonoid", "MultipliesMonoid",
                                    "LogicalOrMonoid", "LogicalAndMonoid"])
def test_row_reduce_monoids_match_jax(graphs, monoid):
    """Each ported monoid over a weighted graph with empty rows: the
    monoid's identity there, the reduce elsewhere (rtol 1e-6; the JAX sum
    within its own rounding, _plus_reduce_atol)."""
    from graphblast_tpu import operations as jops

    J, T = graphs["weighted"]
    want = np.asarray(jops.reduce_matrix_to_vector(
        J, getattr(jgb, monoid)).to_numpy())
    got = tgb.reduce_matrix_to_vector(
        T, getattr(tgb.semiring, monoid)).to_numpy()
    atol = _plus_reduce_atol(T) if monoid == "PlusMonoid" else 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)


def test_scale_rows_checks_dimensions(graphs):
    from graphblast_tpu_torch.dimension import DimensionException

    _, T = graphs["test_pr"]
    short = tgb.Vector(T.nrows - 1, tgb.Storage.DENSE,
                       dense=torch.ones(T.nrows - 1))
    with pytest.raises(DimensionException, match="scaleRows"):
        tgb.scale_matrix_rows(T, short, tgb.PlusDividesSemiring)
    # the non-associative monoids reduce too, as JAX's row reduce does
    J, _ = graphs["test_pr"]
    np.testing.assert_array_equal(
        tgb.reduce_matrix_to_vector(T, tgb.semiring.GreaterMonoid).to_numpy(),
        np.asarray(jgb.reduce_matrix_to_vector(
            J, jgb.semiring.GreaterMonoid).to_numpy()))


# ---------------------------------------------------------- mxv_dual
def _mask(rng, n):
    return (rng.random(n) < 0.5).astype(np.float32)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("mask", [None, "keep", "scmp"])
def test_mxv_dual_plus_times_matches_jax(graphs, transpose, mask):
    """The PlusMultiplies pull over a value plan vs the JAX pull over its
    bilinear plan (interpret mode) on chesapeake, within 1e-5 * max|y|."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu.ops.pallas.bilinear import plan_for as jplan_for
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["chesapeake"]
    rng = np.random.default_rng(21)
    x = rng.standard_normal(T.nrows).astype(np.float32)
    kw = dict(transpose=transpose, mode=jgb.Direction.PULLONLY)
    tkw = dict(transpose=transpose, mode=tgb.Direction.PULLONLY)
    if mask is not None:
        m = _mask(rng, T.nrows)
        kw.update(mask_dense=jnp.asarray(m), mask_scmp=mask == "scmp")
        tkw.update(mask_dense=torch.from_numpy(m), mask_scmp=mask == "scmp")
    jplan = jplan_for(J, transpose=transpose)
    assert jplan is not None
    jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(x), 0.0),
                 jgb.PlusMultipliesSemiring, 0.0, pull_plan=jplan, **kw)
    tf, used_push = mxv_dual(T, DualFrontier.from_dense(torch.from_numpy(x),
                                                        0.0),
                             tgb.PlusMultipliesSemiring, 0.0,
                             pull_plan=vp.plan_for(T, transpose=transpose),
                             **tkw)
    want, got = np.asarray(jf.dense), tf.dense.numpy()
    assert not used_push and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert int(tf.snvals) == int(jf.snvals)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("mask", [None, "keep", "scmp"])
def test_mxv_dual_or_pull_over_ones_plan_matches_jax(graphs, transpose,
                                                     mask):
    """The structure-only LogicalOrAnd pull over a unit-valued plan vs the
    JAX pull over its ones=True plan on chesapeake: equal 0/1 outputs."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu.ops.pallas.bilinear import plan_for as jplan_for
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["chesapeake"]
    rng = np.random.default_rng(22)
    f = (rng.random(T.nrows) < 0.1).astype(np.float32)
    kw = dict(transpose=transpose, mode=jgb.Direction.PULLONLY,
              structure_only=True)
    tkw = dict(transpose=transpose, mode=tgb.Direction.PULLONLY,
               structure_only=True)
    if mask is not None:
        m = _mask(rng, T.nrows)
        kw.update(mask_dense=jnp.asarray(m), mask_scmp=mask == "scmp")
        tkw.update(mask_dense=torch.from_numpy(m), mask_scmp=mask == "scmp")
    jplan = jplan_for(J, transpose=transpose, ones=True)
    assert jplan is not None and jplan.unit_vals
    jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(f), 0.0),
                 jgb.LogicalOrAndSemiring, 0.0, pull_plan=jplan, **kw)
    tf, _ = mxv_dual(T, DualFrontier.from_dense(torch.from_numpy(f), 0.0),
                     tgb.LogicalOrAndSemiring, 0.0,
                     pull_plan=vp.plan_for(T, transpose=transpose, ones=True),
                     **tkw)
    np.testing.assert_array_equal(tf.dense.numpy(), np.asarray(jf.dense))
    assert int(tf.snvals) == int(jf.snvals)


def test_mxv_dual_value_plan_refuses_other_pulls(graphs):
    """An or-pull over a plan with stored values raises (JAX asserts); a
    semiring the value plan does not serve falls through to spmv_pull, as
    the JAX dispatch does, and equals the JAX pull over its own plan."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu.ops.pallas.bilinear import plan_for as jplan_for
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["weighted"]
    f = DualFrontier.from_dense(torch.ones(T.nrows), 0.0)
    plan = vp.plan_for(T, transpose=True)
    pull = dict(transpose=True, mode=tgb.Direction.PULLONLY, pull_plan=plan)
    with pytest.raises(ValueError, match="ones=True"):
        mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0, structure_only=True,
                 **pull)
    jplan = jplan_for(J, transpose=True)
    assert jplan is not None
    x = np.random.default_rng(24).random(T.nrows).astype(np.float32)
    for name, ident, struct in (("MinimumPlus", MAXF32, False),
                                ("PlusMultiplies", 0.0, True)):
        jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(x), ident),
                     getattr(jgb.semiring, f"{name}Semiring"), ident,
                     transpose=True, mode=jgb.Direction.PULLONLY,
                     structure_only=struct, pull_plan=jplan)
        tf, used_push = mxv_dual(
            T, DualFrontier.from_dense(torch.from_numpy(x), float(ident)),
            getattr(tgb.semiring, f"{name}Semiring"), float(ident),
            structure_only=struct, **pull)
        want, got = np.asarray(jf.dense), tf.dense.numpy()
        assert not used_push
        assert int(tf.snvals) == int(jf.snvals) > 0
        if not struct:
            np.testing.assert_array_equal(got, want)
            continue
        # JAX's float32 prefix-sum differences stray from the sums: the
        # port within 1e-5·max|y| of a float64 golden (spmv_pull reads the
        # values: structure_only changes only the LogicalOrAnd pull), and
        # of JAX within JAX's own distance from it
        gold = T.to_scipy().T.astype(np.float64) @ x.astype(np.float64)
        bar = 1e-5 * np.abs(gold).max()
        assert np.abs(got - gold).max() <= bar
        assert np.abs(got - want).max() <= bar + np.abs(want - gold).max()


# ------------------------------------------------------------ PageRank
@pytest.mark.parametrize("mode", ["fused", "stepped"])
@pytest.mark.parametrize("name,eps", [("test_pr", 1e-9),
                                      ("chesapeake", 1e-10),
                                      ("weighted", 1e-10)])
def test_pr_matches_jax(graphs, name, eps, mode):
    J, T = graphs[name]
    want = np.asarray(jax_pr(J, alpha=0.85, eps=eps, mode=mode).to_numpy())
    got = pr(T, alpha=0.85, eps=eps, mode=mode).to_numpy()
    assert got.dtype == np.float32 and got.shape == (T.nrows,)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


def test_pr_matches_jax_fused_over_its_bilinear_plan(graphs, monkeypatch):
    """The JAX fused loop over prepare_pr_plan's α/outdegree-scaled plan
    (the Pallas kernel in interpret mode, forced on as
    tests/test_pallas.py::test_pr_with_bilinear_plan does) vs the port's
    loop over its own plan: the same iteration count within one, ranks
    within rtol 1e-4 / atol 1e-7."""
    from graphblast_tpu.algorithms.pr import _pr_fused as j_fused
    from graphblast_tpu.algorithms.pr import prepare_pr_plan as j_plan
    from graphblast_tpu.ops import gather_dispatch
    from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan

    J, T = graphs["weighted"]
    monkeypatch.setattr(gather_dispatch, "_USE_PALLAS", True)
    jplan = j_plan(J, 0.85)
    assert jplan is not None
    want, jit, _ = j_fused(J, jplan, alpha=0.85, eps=1e-9, max_niter=150)
    got, it, err = _pr_fused(T, prepare_pr_plan(T, 0.85), alpha=0.85,
                             eps=1e-9, max_niter=150)
    assert abs(it - int(jit)) <= 1 and err <= 1e-9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("name", GRAPHS)
def test_pr_golden_matches_jax_golden(graphs, name):
    """The port's vectorised golden vs the JAX loop golden (rtol 1e-5: one
    sums each step in float64, the other in float32)."""
    J, T = graphs[name]
    for eps, niter in ((1e-6, 100), (1e-12, 200)):
        np.testing.assert_allclose(pr_cpu(T, 0.85, eps, niter),
                                   jax_pr_cpu(J, 0.85, eps, niter),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", GRAPHS)
def test_pr_matches_golden(graphs, name):
    """At the fixed point the port's ranks and its golden agree (rtol 1e-3 /
    atol 1e-6, as tests/test_algorithms.py): the golden's out-degree is the
    edge count, the algorithm's the weighted row sum, so the weighted graph
    is compared after dividing its values out."""
    _, T = graphs[name]
    if name == "weighted":
        rows, cols, _, n = _directed(weighted=False)
        T = tgb.Matrix.from_coo(rows, cols, np.ones(len(rows)), n, n,
                                device="cpu")
    got = pr(T, eps=1e-10).to_numpy()
    want = pr_cpu(T, 0.85, eps=1e-14, max_niter=300)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", GRAPHS)
def test_pr_prepared_matches_unprepared(graphs, name):
    """prepare_pr_matrix + prepared=True pulls A's stored CSC values; they
    round the α/outdegree scale in float32 where the plan rounds once from
    float64, so ranks agree to 1e-6 relative."""
    _, T = graphs[name]
    got = pr(prepare_pr_matrix(T, 0.85), eps=1e-10, prepared=True)
    np.testing.assert_allclose(got.to_numpy(), pr(T, eps=1e-10).to_numpy(),
                               rtol=1e-6, atol=1e-9)


def test_pr_weighted_outdegree(graphs):
    """The out-degree is the weighted row sum: scaling every value of A by
    a constant leaves the ranks as they are."""
    _, T = graphs["weighted"]
    rows, cols, vals, n = _directed(weighted=True)
    T3 = tgb.Matrix.from_coo(rows, cols, 3 * vals, n, n, device="cpu")
    np.testing.assert_allclose(pr(T3, eps=1e-10).to_numpy(),
                               pr(T, eps=1e-10).to_numpy(), rtol=1e-5)


def test_pr_stops_by_its_rule(graphs):
    """`it` starts at 1 and the loop runs while err > eps and it <=
    max_niter; p0 = 1/n."""
    from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan

    _, T = graphs["chesapeake"]
    plan = prepare_pr_plan(T, 0.85)
    p, it, err = _pr_fused(T, plan, alpha=0.85, eps=0.0, max_niter=3)
    assert it == 3 and err > 0
    p0, it0, _ = _pr_fused(T, plan, alpha=0.85, eps=1e-6, max_niter=0)
    assert it0 == 0
    np.testing.assert_array_equal(p0.numpy(), np.full(T.nrows, 1 / T.nrows,
                                                      np.float32))
    np.testing.assert_array_equal(
        pr(T, eps=0.0, desc=tgb.DEFAULT.replace(max_niter=3)).to_numpy(),
        p.numpy())
    _, it, err = _pr_fused(T, plan, alpha=0.85, eps=1e-7, max_niter=1000)
    assert err <= 1e-7 and it < 1000


def test_pr_stepped_prints_the_reference_rows(graphs, capsys):
    _, T = graphs["test_pr"]
    p = pr(T, eps=1e-6, mode="stepped",
           desc=tgb.DEFAULT.replace(timing=1)).to_numpy()
    rows = capsys.readouterr().out.strip().splitlines()
    last_err = float(rows[-1].split(", ")[1].split("/")[0])  # "err/n"
    assert len(rows) > 1 and last_err <= 1e-6
    np.testing.assert_array_equal(p, pr(T, eps=1e-6).to_numpy())


def test_pr_refuses_what_is_not_ported(graphs):
    J, T = graphs["test_pr"]
    np.testing.assert_allclose(pr(T, mode="async").to_numpy(),
                               np.asarray(jax_pr(J, mode="async").to_numpy()),
                               rtol=1e-3, atol=1e-6)
    rows, cols, vals, n = _directed(weighted=False)
    C = tgb.Matrix.from_coo(rows, cols, vals, n, n,
                            fmt=tgb.SparseFormat.CSRONLY, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="no route for a one-sided matrix"):
        pr(C)
