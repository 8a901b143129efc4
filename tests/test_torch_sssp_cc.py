"""The port's SSSP and CC slice against the JAX package (graphblast_tpu_torch).

The same graphs, loaded from data/small or made with NumPy from a seed, go
through the JAX functions and the port's on CPU tensors, where the monoid
pull (K4) runs as its plain PyTorch version. Every comparison is exact:
distances are minima of float32 sums taken in the same order (the JAX CPU
path, the plan-less spmv_pull, is exact too), labels and counts are
integers.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import sssp as jax_sssp
from graphblast_tpu.algorithms import sssp_cpu as jax_sssp_cpu
from graphblast_tpu.algorithms.cc import cc as jax_cc
from graphblast_tpu.algorithms.cc import cc_cpu as jax_cc_cpu
from graphblast_tpu.algorithms.cc import verify_cc as jax_verify_cc
from graphblast_tpu_torch.algorithms import (cc, cc_cpu, sssp, sssp_cpu,
                                             verify_cc)
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MAXF = np.float32(np.finfo(np.float32).max)
PULL = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PULLONLY)
JAX_PULL = jgb.Descriptor(mxv_mode=jgb.Direction.PULLONLY)


def _weighted_coo(n=300, m=2500, seed=3):
    """A seeded weighted directed graph: vertices 0..9 have no in-edges
    (unreachable from any other source), n-20.. no out-edges (empty CSR
    rows); weights in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n - 20, m), rng.integers(10, n, m),
            rng.uniform(0.5, 2.0, m), n)


def _components_coo(seed=5):
    """A symmetric graph of three components on shuffled ids (a path
    through each, and random edges within it), and 20 isolated vertices."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(400)
    rows, cols = [], []
    for lo, hi, m in ((0, 100, 300), (100, 250, 400), (250, 380, 260)):
        rows += [ids[lo:hi - 1], ids[rng.integers(lo, hi, m)]]
        cols += [ids[lo + 1:hi], ids[rng.integers(lo, hi, m)]]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    return (np.r_[rows, cols], np.r_[cols, rows], np.ones(2 * len(rows)),
            400)


def _graphs(name):
    """(JAX Matrix, port Matrix) for one named test graph."""
    if name in ("chesapeake", "test_cc"):
        path = os.path.join(DATA, f"{name}.mtx")
        return (jgb.Matrix.from_mtx(path, use_cache=False),
                tgb.Matrix.from_mtx(path, use_cache=False, device="cpu"))
    if name == "grid16":
        from graphblast_tpu.io.rmat import grid_matrix as jgrid
        from graphblast_tpu_torch.io.rmat import grid_matrix

        return jgrid(16), grid_matrix(16, device="cpu")
    if name == "rmat10":
        from graphblast_tpu.io.rmat import rmat_matrix as jrmat
        from graphblast_tpu_torch.io.rmat import rmat_matrix

        return jrmat(10, 16, seed=42), rmat_matrix(10, 16, seed=42,
                                                   device="cpu")
    rows, cols, vals, n = (_weighted_coo() if name == "weighted"
                           else _components_coo())
    return (jgb.Matrix.from_coo(rows, cols, vals, n, n),
            tgb.Matrix.from_coo(rows, cols, vals, n, n, device="cpu"))


GRAPHS = ["chesapeake", "test_cc", "grid16", "rmat10", "weighted",
          "components"]
SSSP_CASES = [("chesapeake", 0), ("chesapeake", 3), ("weighted", 20),
              ("weighted", "hub"), ("grid16", 0), ("grid16", "hub")]
CC_GRAPHS = ["chesapeake", "test_cc", "components", "rmat10"]


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _source(T, s):
    return int(np.argmax(np.diff(T.host_csr()[0]))) if s == "hub" else s


# ------------------------------------------------------------------ SSSP
@pytest.mark.parametrize("name,source", SSSP_CASES)
def test_sssp_matches_jax(graphs, name, source):
    """Pull-only SSSP, both modes, bitwise equal to the JAX `sssp`
    (PULLONLY), to the JAX golden and to the port's golden; the same
    iteration count as the JAX fused loop."""
    from graphblast_tpu.algorithms.common import edge_cap_for
    from graphblast_tpu.algorithms.sssp import _sssp_fused as j_fused
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused

    J, T = graphs[name]
    s = _source(T, source)
    want = np.asarray(jax_sssp(J, s, desc=JAX_PULL).to_numpy())
    np.testing.assert_array_equal(want, jax_sssp_cpu(J, s))
    np.testing.assert_array_equal(sssp_cpu(T, s), want)
    for mode in ("fused", "stepped"):
        got = sssp(T, s, PULL, mode=mode).to_numpy()
        assert got.dtype == np.float32 and got.shape == (T.nrows,)
        np.testing.assert_array_equal(got, want, err_msg=mode)
    if name == "weighted":
        assert (want == MAXF).sum() >= 9      # unreachable vertices
    _, jit = j_fused(J, s, None, edge_cap=edge_cap_for(J, JAX_PULL),
                     switchpoint=0.01, mode=jgb.Direction.PULLONLY,
                     sort_push=True, max_niter=1000)
    _, it = _sssp_fused(T, s, mp.plan_for_monoid(T, transpose=True),
                        switchpoint=0.01, mode=tgb.Direction.PULLONLY,
                        max_niter=1000)
    assert it == int(jit) > 0


def test_sssp_matches_jax_over_its_monoid_kernel(graphs, monkeypatch):
    """The JAX `sssp` over its Pallas monoid pull (interpret mode, forced
    on as tests/test_algorithms.py::test_sssp_monoid_pull_parity does)."""
    J, T = graphs["chesapeake"]
    monkeypatch.setenv("GRB_MONOID_PULL_FORCE", "1")
    want = np.asarray(jax_sssp(J, 3, desc=JAX_PULL).to_numpy())
    np.testing.assert_array_equal(sssp(T, 3, PULL).to_numpy(), want)


@pytest.mark.parametrize("name", ["chesapeake", "weighted", "grid16",
                                  "rmat10"])
def test_sssp_golden_matches_jax_golden(graphs, name):
    """The port's Bellman-Ford golden vs the JAX Dijkstra golden, from
    vertex 0 and the top hub: equal."""
    J, T = graphs[name]
    for s in (0, _source(T, "hub")):
        np.testing.assert_array_equal(sssp_cpu(T, s), jax_sssp_cpu(J, s))


def test_sssp_max_niter_stops_the_loop(graphs):
    """`it` starts at 1 and the loop runs while succ > 0 and it <=
    max_niter: no iteration leaves v0, one relaxes the source's edges."""
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused

    _, T = graphs["grid16"]
    plan = mp.plan_for_monoid(T, transpose=True)
    kw = dict(switchpoint=0.01, mode=tgb.Direction.PULLONLY)
    v0, it0 = _sssp_fused(T, 17, plan, max_niter=0, **kw)
    assert it0 == 0
    want = np.full(T.nrows, MAXF)
    want[17] = 0
    np.testing.assert_array_equal(v0.numpy(), want)
    v1, it1 = _sssp_fused(T, 17, plan, max_niter=1, **kw)
    want[[1, 16, 18, 33]] = 1
    assert it1 == 1
    np.testing.assert_array_equal(v1.numpy(), want)
    np.testing.assert_array_equal(
        sssp(T, 17, PULL.replace(max_niter=1)).to_numpy(), want)


def test_sssp_stepped_prints_the_reference_rows(graphs, capsys):
    _, T = graphs["chesapeake"]
    got = sssp(T, 0, PULL.replace(timing=1), mode="stepped").to_numpy()
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows and all(r.split(", ")[3] == "pull" for r in rows)
    assert rows[-1].split(", ")[1] == f"0/{T.nrows}"
    assert int(rows[-1].split(", ")[2]) == int((got == MAXF).sum())


def test_sssp_push_modes_run(graphs):
    """The default descriptor's PUSHPULL runs and gives the JAX PUSHPULL
    sssp's distances and the golden in both modes, as PUSHONLY does; any
    other mode runs stepped, as the JAX package's does."""
    J, T = graphs["chesapeake"]
    want = np.asarray(jax_sssp(J, 0).to_numpy())
    np.testing.assert_array_equal(want, sssp_cpu(T, 0))
    push = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PUSHONLY)
    for mode in ("fused", "stepped"):
        np.testing.assert_array_equal(
            sssp(T, 0, tgb.DEFAULT, mode=mode).to_numpy(), want)
        np.testing.assert_array_equal(sssp(T, 0, push, mode=mode).to_numpy(),
                                      sssp_cpu(T, 0))
    np.testing.assert_array_equal(
        sssp(T, 0, PULL, mode="async").to_numpy(),
        np.asarray(jax_sssp(J, 0, JAX_PULL, mode="async").to_numpy()))


# -------------------------------------------------------------------- CC
@pytest.mark.parametrize("name", CC_GRAPHS)
def test_cc_matches_jax(graphs, name):
    """Labels of both modes exactly equal to the JAX `cc` and to the port's
    golden, verify_cc holding; the same iteration count as the JAX fused
    loop."""
    from graphblast_tpu.algorithms.cc import _as_int_matrix
    from graphblast_tpu.algorithms.cc import _cc_fused as j_fused
    from graphblast_tpu_torch.algorithms.cc import _cc_fused

    J, T = graphs[name]
    want = np.asarray(jax_cc(J).to_numpy())
    assert jax_verify_cc(J, want)
    for mode in ("fused", "stepped"):
        got = cc(T, mode=mode).to_numpy()
        assert got.dtype == np.int32 and got.shape == (T.nrows,)
        np.testing.assert_array_equal(got, want, err_msg=mode)
    np.testing.assert_array_equal(cc_cpu(T), want)
    assert verify_cc(T, want)
    _, jit = j_fused(_as_int_matrix(J), None, max_niter=1000)
    _, it = _cc_fused(T, mp.plan_for_monoid(T, ones=True), max_niter=1000)
    assert it == int(jit) > 0


@pytest.mark.parametrize("name", ["chesapeake", "test_cc", "components"])
def test_cc_matches_jax_over_its_monoid_kernel(graphs, name, monkeypatch):
    """The JAX `cc` over its Pallas monoid pull (interpret mode, forced on
    as tests/test_algorithms.py::test_cc_monoid_pull_parity does)."""
    J, T = graphs[name]
    monkeypatch.setenv("GRB_MONOID_PULL_FORCE", "1")
    np.testing.assert_array_equal(cc(T).to_numpy(),
                                  np.asarray(jax_cc(J).to_numpy()))


@pytest.mark.parametrize("name", CC_GRAPHS + ["weighted"])
def test_cc_golden_and_verifier_match_jax(graphs, name):
    """The port's vectorised golden vs the JAX per-edge golden (weak
    components on the directed graph too), and verify_cc against the JAX
    verifier on the golden and on a spoiled labelling."""
    J, T = graphs[name]
    want = jax_cc_cpu(J)
    got = cc_cpu(T)
    np.testing.assert_array_equal(got, want)
    assert verify_cc(T, got) and jax_verify_cc(J, want)
    rp = T.host_csr()[0]
    u = int(np.flatnonzero(np.diff(rp))[0])       # a vertex with an edge
    bad = got.copy()
    bad[u] = T.nrows
    assert not verify_cc(T, bad) and not jax_verify_cc(J, bad)


def test_cc_components_and_isolated_vertices(graphs):
    _, T = graphs["components"]
    labels = cc(T).to_numpy()
    assert len(np.unique(labels)) == 3 + 20
    deg = np.diff(T.host_csr()[0])
    np.testing.assert_array_equal(labels[deg == 0],
                                  np.flatnonzero(deg == 0))


def test_cc_stepped_prints_the_reference_rows(graphs, capsys):
    _, T = graphs["test_cc"]
    cc(T, desc=tgb.DEFAULT.replace(timing=1), mode="stepped")
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows and rows[-1].split(", ")[1] == f"0/{T.nrows}"


def test_cc_refuses_csc_only_and_unknown_mode(graphs):
    """A CSC-only matrix raises: cc pulls over the CSR, and the JAX package
    has no route for it either; any mode but "fused" runs stepped, as the
    JAX package's does. (At n >= 2^24 cc takes the plan-less spmv_pull,
    held in tests/test_torch_mis_gc.py.)"""
    J, T = graphs["test_cc"]
    with pytest.raises(NotImplementedError,
                       match="no route for a CSC-only matrix"):
        cc(dataclasses.replace(T, row_ptr=None, col_ind=None, row_ind=None,
                               val=None))
    np.testing.assert_array_equal(
        cc(T, mode="async").to_numpy(),
        np.asarray(jax_cc(J, mode="async").to_numpy()))


# -------------------------------------------------------------- mxv_dual
def _frontier(rng, n):
    return np.where(rng.random(n) < 0.4, MAXF,
                    rng.random(n) * 5).astype(np.float32)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("mask", [None, "keep", "scmp"])
def test_mxv_dual_monoid_pull_matches_jax(graphs, transpose, mask):
    """The MinimumPlus pull over a monoid plan with SSSP's postprocess vs
    the JAX PULLONLY pull (the plan-less spmv_pull) on the weighted graph:
    equal y and nvals."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["weighted"]
    rng = np.random.default_rng(23)
    x = _frontier(rng, T.nrows)
    v = _frontier(rng, T.nrows)
    kw = dict(transpose=transpose, mode=jgb.Direction.PULLONLY,
              postprocess=lambda y: jnp.where(y < jnp.asarray(v), y, MAXF))
    tkw = dict(transpose=transpose, mode=tgb.Direction.PULLONLY,
               postprocess=lambda y: torch.where(y < torch.from_numpy(v), y,
                                                 float(MAXF)))
    if mask is not None:
        m = (rng.random(T.nrows) < 0.5).astype(np.float32)
        kw.update(mask_dense=jnp.asarray(m), mask_scmp=mask == "scmp")
        tkw.update(mask_dense=torch.from_numpy(m), mask_scmp=mask == "scmp")
    jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(x), MAXF),
                 jgb.semiring.MinimumPlusSemiring, MAXF, **kw)
    tf, used_push = mxv_dual(
        T, DualFrontier.from_dense(torch.from_numpy(x), float(MAXF)),
        tgb.MinimumPlusSemiring, float(MAXF),
        pull_plan=mp.plan_for_monoid(T, transpose=transpose), **tkw)
    assert not used_push
    np.testing.assert_array_equal(tf.dense.numpy(), np.asarray(jf.dense))
    assert int(tf.snvals) == int(jf.snvals) > 0


def test_mxv_dual_postprocess_follows_the_mask(graphs):
    """postprocess sees the masked y, and nvals counts what it returns."""
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    _, T = graphs["chesapeake"]
    seen = []

    def keep_two(y):
        seen.append(y.clone())
        out = torch.full_like(y, float(MAXF))
        out[:2] = y[:2]
        return out

    x = torch.zeros(T.nrows)
    mask = torch.ones(T.nrows)
    mask[0] = 0
    f2, _ = mxv_dual(T, DualFrontier.from_dense(x, float(MAXF)),
                     tgb.MinimumPlusSemiring, float(MAXF), transpose=True,
                     mask_dense=mask, mode=tgb.Direction.PULLONLY,
                     pull_plan=mp.plan_for_monoid(T, transpose=True),
                     postprocess=keep_two)
    assert seen[0][0] == MAXF and seen[0][1] == 1.0   # row 0 masked out
    assert int(f2.snvals) == 1
    np.testing.assert_array_equal(f2.dense.numpy()[2:], MAXF)


def test_mxv_dual_monoid_plan_refuses_other_pulls(graphs):
    """Over a monoid plan, anything but a SEMIRING_MAP semiring on a float32
    frontier with values falls through to spmv_pull, as the JAX dispatch
    does, and equals the JAX pull over its own monoid plan; a plan of
    another size raises."""
    from graphblast_tpu.ops.dispatch import DualFrontier as JFrontier
    from graphblast_tpu.ops.dispatch import mxv_dual as jmxv
    from graphblast_tpu.ops.pallas.monopull import (plan_for_monoid as
                                                    jplan_for_monoid)
    from graphblast_tpu_torch.ops.dispatch import DualFrontier, mxv_dual

    J, T = graphs["weighted"]
    plan = mp.plan_for_monoid(T, transpose=True)
    pull = dict(transpose=True, mode=tgb.Direction.PULLONLY, pull_plan=plan)
    jplan = jplan_for_monoid(J, transpose=True)
    assert jplan is not None
    # finite: FLT_MAX + a weight stays FLT_MAX only in float32
    x = (np.random.default_rng(25).random(T.nrows) * 5).astype(np.float32)
    for name, ident, struct, dtype in (
            ("MinimumPlus", MAXF, False, np.float64),   # not float32
            ("PlusMultiplies", 0.0, False, np.float32),  # not SEMIRING_MAP
            ("MinimumPlus", MAXF, True, np.float32)):    # structure only
        jf, _ = jmxv(J, JFrontier.from_dense(jnp.asarray(x), ident),
                     getattr(jgb.semiring, f"{name}Semiring"), ident,
                     transpose=True, mode=jgb.Direction.PULLONLY,
                     structure_only=struct, pull_plan=jplan)
        # the identity in the frontier's dtype (the Minimum monoid's is its
        # largest value)
        tident = float(np.finfo(dtype).max) if ident else 0.0
        tf, used_push = mxv_dual(
            T, DualFrontier.from_dense(torch.from_numpy(x.astype(dtype)),
                                       tident),
            getattr(tgb.semiring, f"{name}Semiring"), tident,
            structure_only=struct, **pull)
        want = np.asarray(jf.dense, np.float64)
        got = tf.dense.numpy().astype(np.float64)
        assert not used_push and tf.dense.dtype == torch.from_numpy(
            np.zeros(0, dtype)).dtype
        assert int(tf.snvals) == int(jf.snvals) > 0
        if dtype == np.float64:
            # JAX computes in float32 (x64 off): the same reached rows and
            # sums within float32 rounding; the port equals its own
            # plan-less pull
            reached = want < MAXF
            np.testing.assert_array_equal(got < np.finfo(np.float64).max,
                                          reached)
            np.testing.assert_allclose(got[reached], want[reached],
                                       rtol=1e-5)
            alone, _ = mxv_dual(
                T, DualFrontier.from_dense(torch.from_numpy(x.astype(dtype)),
                                           tident),
                getattr(tgb.semiring, f"{name}Semiring"), tident,
                transpose=True, mode=tgb.Direction.PULLONLY)
            assert torch.equal(tf.dense, alone.dense)
        elif name.startswith("Plus"):
            # JAX's float32 prefix-sum differences stray from the sums (the
            # ROADMAP's caveat): the port within 1e-5·max|y| of a float64
            # golden, and of JAX within JAX's own distance from it
            gold = T.to_scipy().T.astype(np.float64) @ x.astype(np.float64)
            bar = 1e-5 * np.abs(gold).max()
            assert np.abs(got - gold).max() <= bar
            assert (np.abs(got - want).max()
                    <= bar + np.abs(want - gold).max())
        else:
            np.testing.assert_array_equal(got, want)
    f = DualFrontier.from_dense(torch.zeros(T.nrows), float(MAXF))
    with pytest.raises(ValueError, match="output rows"):
        mxv_dual(T, f, tgb.MinimumPlusSemiring, float(MAXF),
                 **dict(pull, pull_plan=mp.MonoidPlan(
                     3, T.nrows, plan.ptr[:4], plan.ind, plan.val)))
