"""The port's MIS, graph colouring, plan-less CC and stepped BFS against the
JAX package (graphblast_tpu_torch).

The two packages draw their random weights from different generators, so
the loops are held to each other with the same weights w0, made with NumPy
and handed to both; the entry points, which draw their own, are held to the
verifiers. On CPU tensors the gather K6 and the or-pull prefix count K5 run
as their plain versions. Every comparison is exact: memberships, colours,
labels and levels are integers.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import reference as jref
from graphblast_tpu_torch.algorithms import reference as tref
from graphblast_tpu_torch.types import SparseFormat

# the packages export the functions mis and gc under their modules' names
jmis_mod = importlib.import_module("graphblast_tpu.algorithms.mis")
jgc_mod = importlib.import_module("graphblast_tpu.algorithms.gc")
tmis_mod = importlib.import_module("graphblast_tpu_torch.algorithms.mis")
tgc_mod = importlib.import_module("graphblast_tpu_torch.algorithms.gc")

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MAX_NITER = 1000


def _graphs(name):
    """(JAX Matrix, port Matrix) for one named test graph."""
    if name in ("chesapeake", "test_mis"):
        path = os.path.join(DATA, f"{name}.mtx")
        return (jgb.Matrix.from_mtx(path, use_cache=False),
                tgb.Matrix.from_mtx(path, use_cache=False, device="cpu"))
    if name == "rmat9":
        from graphblast_tpu.io.rmat import rmat_matrix as jrmat
        from graphblast_tpu_torch.io.rmat import rmat_matrix

        return jrmat(9, 16, seed=42), rmat_matrix(9, 16, seed=42,
                                                  device="cpu")
    if name == "grid12":
        from graphblast_tpu.io.rmat import grid_matrix as jgrid
        from graphblast_tpu_torch.io.rmat import grid_matrix

        return jgrid(12), grid_matrix(12, device="cpu")
    if name == "csronly":
        # chesapeake narrowed to its CSR, as tests/test_algorithms2.py does
        J, T = _graphs("chesapeake")
        R = J.set_storage(jgb.SparseFormat.CSRONLY)
        leaves = {k: np.asarray(getattr(R, k))
                  for k in ("row_ptr", "col_ind", "row_ind", "val")}
        T = tgb.Matrix.from_numpy_arrays(leaves, R.nrows, R.ncols, R.nvals,
                                         symmetric=False, device="cpu")
        assert R.col_ptr is None and T.col_ptr is None
        assert T.format == SparseFormat.CSRONLY
        return R, T
    raise KeyError(name)


GRAPHS = ["chesapeake", "test_mis", "rmat9", "grid12", "csronly"]


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _w0(n, seed, ties=False):
    """Candidate weights in [1, 2^30); `ties` draws from 1..3, so that many
    adjacent vertices tie."""
    rng = np.random.default_rng(seed)
    hi = 4 if ties else 1 << 30
    return rng.integers(1, hi, n).astype(np.int32)


def _both(w0):
    return jnp.asarray(w0), torch.from_numpy(w0.copy())


# ------------------------------------------------------------------- MIS
@pytest.mark.parametrize("name", GRAPHS)
def test_mis_loop_matches_jax(graphs, name):
    """_mis_fused with the same w0: memberships and round counts equal; the
    set is a maximal independent set (on the CSRONLY graph, of the full
    graph, as tests/test_algorithms2.py checks it)."""
    J, T = graphs[name]
    jw, tw = _both(_w0(T.nrows, 1))
    want, jit = jmis_mod._mis_fused(J, jw, max_niter=MAX_NITER)
    got, it = tmis_mod._mis_fused(T, tw, max_niter=MAX_NITER)
    assert got.dtype == torch.int32 and got.shape == (T.nrows,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert it == int(jit) > 0
    full = graphs["chesapeake"][1] if name == "csronly" else T
    assert tref.verify_mis(full, got.numpy())


def test_mis_loop_with_ties_matches_jax(graphs):
    """Weights in 1..3: adjacent ties keep both vertices out of the set, in
    both packages alike, and the verifiers agree on the outcome."""
    J, T = graphs["rmat9"]
    jw, tw = _both(_w0(T.nrows, 2, ties=True))
    want, _ = jmis_mod._mis_fused(J, jw, max_niter=MAX_NITER)
    got, _ = tmis_mod._mis_fused(T, tw, max_niter=MAX_NITER)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tref.verify_mis(T, got.numpy()) == jref.verify_mis(
        J, np.asarray(want))


def test_mis_max_niter_and_candidates(graphs):
    """No round leaves the set empty; candidates of weight 0 never enter."""
    _, T = graphs["grid12"]
    w0 = torch.from_numpy(_w0(T.nrows, 3))
    v, it = tmis_mod._mis_fused(T, w0, max_niter=0)
    assert it == 0 and int(v.sum()) == 0
    w0[: T.nrows // 2] = 0
    v = tmis_mod.mis_inner(T, w0)
    assert int(v[: T.nrows // 2].sum()) == 0 and int(v.sum()) > 0


@pytest.mark.parametrize("name", ["chesapeake", "rmat9", "csronly"])
def test_mis_entry_point_verifies(graphs, name, capsys):
    """mis() in both modes: a verified MIS, the same set from the same seed,
    int32 0/1; the stepped mode prints one row per round."""
    _, T = graphs[name]
    full = graphs["chesapeake"][1] if name == "csronly" else T
    v = tgb.mis(T, seed=2).to_numpy()
    assert v.dtype == np.int32 and set(np.unique(v)) <= {0, 1}
    assert tgb.verify_mis(full, v)
    stepped = tgb.mis(T, seed=2, desc=tgb.DEFAULT.replace(timing=1),
                      mode="stepped").to_numpy()
    np.testing.assert_array_equal(stepped, v)
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows and rows[-1].split(", ")[1] == f"0/{T.nrows}"
    with pytest.raises(ValueError):
        tgb.mis(T, mode="async")


def test_random_weights_are_seeded_and_in_range():
    a = tmis_mod.random_weights(5000, 7, "cpu")
    assert a.dtype == torch.int32 and int(a.min()) >= 1
    assert int(a.max()) < 1 << 30
    assert torch.equal(a, tmis_mod.random_weights(5000, 7, "cpu"))
    assert not torch.equal(a, tmis_mod.random_weights(5000, 8, "cpu"))


# -------------------------------------------------------------------- GC
@pytest.mark.parametrize("algo", ["is", "jp", "mis"])
@pytest.mark.parametrize("name", GRAPHS)
def test_gc_loops_match_jax(graphs, name, algo):
    """The three colouring loops with the same w0: colours equal, and a
    proper colouring of the full graph."""
    J, T = graphs[name]
    jw, tw = _both(_w0(T.nrows, 4))
    if algo == "is":
        want = jgc_mod._gc_is_fused(J, jw, max_niter=MAX_NITER)
        got, rounds = tgc_mod._gc_is_fused(T, tw, max_niter=MAX_NITER)
        assert rounds == int(got.max()) + 1   # the last round colours none
    elif algo == "jp":
        want = jgc_mod._gc_jp_fused(J, jw, max_colors=64,
                                    max_niter=MAX_NITER)
        got, rounds = tgc_mod._gc_jp_fused(T, tw, max_colors=64,
                                           max_niter=MAX_NITER)
        assert rounds >= int(got.max()) + 1
    else:
        want = jgc_mod._gc_mis(J, jw, jgb.DEFAULT)
        got, used = tgc_mod._gc_mis(T, tw, tgb.DEFAULT)
        assert used == int(got.max())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = graphs["chesapeake"][1] if name == "csronly" else T
    assert tref.verify_gc(full, got.numpy())


def test_gc_jp_saturates_at_max_colors(graphs):
    """With fewer colours allowed than the graph needs, the minimum unused
    colour saturates at max_colors in both packages alike."""
    J, T = graphs["rmat9"]
    jw, tw = _both(_w0(T.nrows, 5))
    want = jgc_mod._gc_jp_fused(J, jw, max_colors=3, max_niter=MAX_NITER)
    got, _ = tgc_mod._gc_jp_fused(T, tw, max_colors=3, max_niter=MAX_NITER)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) == 3


@pytest.mark.parametrize("algo", ["is", "cusparse", "jp", "mis"])
def test_gc_entry_point_verifies(graphs, algo):
    _, T = graphs["rmat9"]
    c = tgb.gc(T, seed=1, algo=algo).to_numpy()
    assert c.dtype == np.int32 and tgb.verify_gc(T, c)
    np.testing.assert_array_equal(tgb.gc(T, seed=1, algo=algo).to_numpy(), c)


def test_gc_refuses_an_unknown_algo(graphs):
    _, T = graphs["chesapeake"]
    with pytest.raises(ValueError, match="unknown gc algo"):
        tgb.gc(T, algo="greedy")


# --------------------------------------------------------- the goldens
def _spoil_mis(T, s):
    """Two spoiled sets: a member's neighbour added (not independent), and
    a member removed whose neighbours are all outside (not maximal)."""
    rp, ci, _ = T.host_csr()
    u = next(i for i in range(T.nrows) if s[i]
             and any(c != i for c in ci[rp[i]:rp[i + 1]]))
    nbr = next(c for c in ci[rp[u]:rp[u + 1]] if c != u)
    dependent = s.copy()
    dependent[nbr] = 1
    not_maximal = s.copy()
    not_maximal[u] = 0
    return dependent, not_maximal


@pytest.mark.parametrize("name", ["chesapeake", "test_mis", "rmat9",
                                  "grid12"])
def test_goldens_and_verifiers_match_jax(graphs, name):
    """mis_cpu and gc_cpu equal the JAX goldens; the vectorised verifiers
    agree with the JAX per-vertex loops on the goldens and on spoiled
    sets and colourings."""
    J, T = graphs[name]
    s = tref.mis_cpu(T, seed=3)
    np.testing.assert_array_equal(s, jref.mis_cpu(J, seed=3))
    c = tref.gc_cpu(T, seed=3)
    np.testing.assert_array_equal(c, jref.gc_cpu(J, seed=3))
    rp, ci, _ = T.host_csr()
    u = int(np.flatnonzero(np.diff(rp))[0])
    nbr = next(int(x) for x in ci[rp[u]:rp[u + 1]] if x != u)
    same = c.copy()
    same[nbr] = same[u]
    zero = c.copy()
    zero[u] = 0
    sets = [s, *_spoil_mis(T, s), np.zeros_like(s)]
    for want_ok, cand in zip((True, False, False, False), sets):
        assert tref.verify_mis(T, cand) == jref.verify_mis(J, cand) \
            == want_ok
    for want_ok, cand in zip((True, False, False), (c, same, zero)):
        assert tref.verify_gc(T, cand) == jref.verify_gc(J, cand) == want_ok


def test_verify_mis_needs_isolated_vertices_in_the_set():
    """An isolated vertex (no edge but a self-loop) must be a member."""
    rows, cols = np.array([0, 1, 2]), np.array([1, 0, 2])
    J = jgb.Matrix.from_coo(rows, cols, np.ones(3), 3, 3)
    T = tgb.Matrix.from_coo(rows, cols, np.ones(3), 3, 3, device="cpu")
    for cand, ok in (([1, 0, 1], True), ([1, 0, 0], False),
                     ([0, 1, 1], True), ([1, 1, 1], False)):
        cand = np.array(cand, np.int32)
        assert tref.verify_mis(T, cand) == jref.verify_mis(J, cand) == ok


# -------------------------------------------------------- plan-less CC
@pytest.mark.parametrize("name", ["chesapeake", "rmat9", "grid12"])
def test_cc_without_a_plan_matches_jax(graphs, name):
    """_cc_fused with no plan (the spmv_pull route of n >= 2^24) vs the JAX
    _cc_fused with no plan: labels and iteration counts equal, and equal to
    the K4 route's."""
    from graphblast_tpu.algorithms.cc import _as_int_matrix
    from graphblast_tpu.algorithms.cc import _cc_fused as j_fused
    from graphblast_tpu_torch.algorithms.cc import _cc_fused
    from graphblast_tpu_torch.ops.kernels.monoid_pull import plan_for_monoid

    J, T = graphs[name]
    want, jit = j_fused(_as_int_matrix(J), None, max_niter=MAX_NITER)
    got, it = _cc_fused(T, None, max_niter=MAX_NITER)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert it == int(jit) > 0
    k4, it4 = _cc_fused(T, plan_for_monoid(T, ones=True),
                        max_niter=MAX_NITER)
    assert torch.equal(k4, got) and it4 == it


def test_cc_pulls_without_a_plan_from_2_24_vertices():
    """At n = 2^24 cc() no longer raises: it takes the plan-less pull and
    equals the golden. A graph of 2^24 vertices, 2,000 edges between its
    first and last 3,000."""
    n = 1 << 24
    rng = np.random.default_rng(0)
    r, c = rng.integers(n - 3000, n, 2000), rng.integers(0, 3000, 2000)
    T = tgb.Matrix.from_coo(np.r_[r, c], np.r_[c, r], np.ones(4000), n, n,
                            device="cpu")
    labels = tgb.cc(T).to_numpy()
    assert "csr/monoid/ones" not in T._plans    # no K4 plan was built
    np.testing.assert_array_equal(labels, tgb.cc_cpu(T))
    assert tgb.verify_cc(T, labels)


# ------------------------------------------------------- stepped BFS
@pytest.mark.parametrize("name", ["chesapeake", "rmat9", "grid12"])
def test_stepped_bfs_pulls_without_a_plan(graphs, name, monkeypatch):
    """Stepped BFS takes the plan-less route (K5 then the boundary gather
    K6, once per iteration each, and never K1) and equals the golden and
    the JAX stepped BFS."""
    from graphblast_tpu_torch.ops import spmv as spmv_mod
    from graphblast_tpu_torch.ops import dispatch as dispatch_mod

    J, T = graphs[name]
    calls = {"k5": 0}
    k5 = spmv_mod.orpull_bit_csum

    def counting_k5(*a):
        calls["k5"] += 1
        return k5(*a)

    def no_k1(*a):
        raise AssertionError("stepped BFS reached the bitmap pull")

    monkeypatch.setattr(spmv_mod, "orpull_bit_csum", counting_k5)
    monkeypatch.setattr(dispatch_mod, "spmv_bitmap_pull", no_k1)
    desc = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PULLONLY)
    s = int(np.argmax(np.diff(T.host_csr()[0])))
    got = tgb.algorithms.bfs(T, s, desc, mode="stepped").to_numpy()
    np.testing.assert_array_equal(got, tgb.algorithms.bfs_cpu(T, s))
    assert calls["k5"] == int(got.max())   # one per iteration
    jdesc = jgb.BFS_TUNED.replace(mxv_mode=jgb.Direction.PULLONLY)
    want = np.asarray(jgb.algorithms.bfs(J, s, jdesc,
                                         mode="stepped").to_numpy())
    np.testing.assert_array_equal(got, want)


def test_value_bfs_pulls_without_a_plan(graphs):
    """A descriptor that is not structure-only has no bitmap plan: both
    modes pull with spmv_pull's value route and equal the golden."""
    _, T = graphs["grid12"]
    desc = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PULLONLY)
    for mode in ("fused", "stepped"):
        got = tgb.algorithms.bfs(T, 5, desc, mode=mode).to_numpy()
        np.testing.assert_array_equal(got, tgb.algorithms.bfs_cpu(T, 5))


def test_csc_int_arrays(graphs):
    """The CSC with int32 values, the CSR for a CSRONLY matrix."""
    from graphblast_tpu.algorithms.common import csc_int_arrays as jcsc
    from graphblast_tpu_torch.algorithms.common import csc_int_arrays

    for name in ("rmat9", "csronly"):
        J, T = graphs[name]
        for a, b in zip(csc_int_arrays(T), jcsc(J)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    T = graphs["csronly"][1]
    assert csc_int_arrays(T)[0] is T.row_ptr
