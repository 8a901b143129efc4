"""The port's BFS slice against the JAX package (graphblast_tpu_torch).

The same graphs go through the JAX `bfs`, the JAX NumPy golden `bfs_cpu`,
and the port's `bfs` (both modes, on CPU tensors, so K1 runs as its plain
version) and `bfs_cpu`. Levels are small integers in float32: every
comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import bfs as jax_bfs
from graphblast_tpu.algorithms import bfs_cpu as jax_bfs_cpu
from graphblast_tpu_torch.algorithms import bfs, bfs_cpu, reference

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
PULL = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PULLONLY)
JAX_PULL = jgb.BFS_TUNED.replace(mxv_mode=jgb.Direction.PULLONLY)


def _directed_coo():
    rng = np.random.default_rng(7)
    n, m = 3000, 25000
    return rng.integers(0, n, m), rng.integers(0, n, m), n


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
    if name == "directed":
        rows, cols, n = _directed_coo()
        return (jgb.Matrix.from_coo(rows, cols, np.ones(len(rows)), n, n),
                tgb.Matrix.from_coo(rows, cols, np.ones(len(rows)), n, n,
                                    device="cpu"))
    if name == "grid16":
        from graphblast_tpu.io.rmat import grid_matrix as jgrid
        from graphblast_tpu_torch.io.rmat import grid_matrix

        return jgrid(16), grid_matrix(16, device="cpu")
    raise KeyError(name)


GRAPHS = ["chesapeake", "rmat10", "directed", "grid16"]


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _sources(T):
    deg = np.diff(T.host_csr()[0])
    return [0, int(np.argmax(deg))]


@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_levels_match_jax(graphs, name):
    J, T = graphs[name]
    assert not T.symmetric if name == "directed" else T.symmetric
    for s in _sources(T):
        want = np.asarray(jax_bfs(J, s, desc=JAX_PULL).to_numpy())
        np.testing.assert_array_equal(want, jax_bfs_cpu(J, s))
        np.testing.assert_array_equal(bfs_cpu(T, s), want)
        for mode in ("fused", "stepped"):
            got = bfs(T, s, PULL, mode=mode).to_numpy()
            assert got.dtype == np.float32 and got.shape == (T.nrows,)
            np.testing.assert_array_equal(got, want, err_msg=f"{s} {mode}")


def test_bfs_golden_matches_jax_golden_on_hubs():
    """The port's level-synchronous golden vs the JAX queue golden on a
    larger RMAT, from its 4 highest-degree sources."""
    from graphblast_tpu.io.rmat import rmat_matrix as jrmat
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    J, T = jrmat(12, 8, seed=3), rmat_matrix(12, 8, seed=3, device="cpu")
    deg = np.diff(T.host_csr()[0])
    for s in np.argsort(deg)[::-1][:4]:
        np.testing.assert_array_equal(bfs_cpu(T, int(s)),
                                      jax_bfs_cpu(J, int(s)))


def test_bfs_on_a_graph_carried_across(graphs):
    """A Matrix rebuilt from the JAX Matrix's (padded) leaves holds the same
    arrays and gives the same levels."""
    from graphblast_tpu_torch.matrix import LEAVES, Matrix

    for name in ("directed", "rmat10"):
        J, T = graphs[name]
        arrays = {k: (None if getattr(J, k) is None
                      else np.asarray(getattr(J, k))) for k in LEAVES}
        C = Matrix.from_numpy_arrays(arrays, J.nrows, J.ncols, J.nvals,
                                     J.symmetric, device="cpu")
        assert (C.format, C.symmetric, C.nvals) == (T.format, T.symmetric,
                                                    T.nvals)
        for k in LEAVES:
            np.testing.assert_array_equal(getattr(C, k).numpy(),
                                          getattr(T, k).numpy(), err_msg=k)
        s = _sources(T)[1]
        np.testing.assert_array_equal(bfs(C, s, PULL).to_numpy(),
                                      bfs(T, s, PULL).to_numpy())


def test_bfs_stepped_prints_the_reference_rows(graphs, capsys):
    _, T = graphs["chesapeake"]
    bfs(T, 0, PULL.replace(timing=1), mode="stepped")
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows and all(r.split(", ")[3] == "pull" for r in rows)
    assert rows[-1].split(", ")[1] == f"0/{T.nrows}"


def test_bfs_max_niter_stops_the_loop(graphs):
    _, T = graphs["grid16"]
    got = bfs(T, 0, PULL.replace(max_niter=3)).to_numpy()
    assert got.max() == 3
    np.testing.assert_array_equal(got, reference.bfs_cpu(T, 0, max_depth=3))


def test_push_modes_run(graphs):
    """PUSHPULL (BFS_TUNED's default) runs and gives the JAX PUSHPULL bfs's
    levels and the golden in both modes, as PUSHONLY does; any other mode
    runs stepped, as the JAX package's does."""
    J, T = graphs["chesapeake"]
    want = np.asarray(jax_bfs(J, 0, jgb.BFS_TUNED).to_numpy())
    np.testing.assert_array_equal(want, bfs_cpu(T, 0))
    push = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PUSHONLY)
    for mode in ("fused", "stepped"):
        np.testing.assert_array_equal(
            bfs(T, 0, tgb.BFS_TUNED, mode=mode).to_numpy(), want)
        np.testing.assert_array_equal(bfs(T, 0, push, mode=mode).to_numpy(),
                                      bfs_cpu(T, 0))
    np.testing.assert_array_equal(
        bfs(T, 0, PULL, mode="async").to_numpy(),
        np.asarray(jax_bfs(J, 0, JAX_PULL, mode="async").to_numpy()))


def test_pull_without_a_plan_matches_the_plan_and_pushpull_runs(graphs):
    """With no plan, mxv_dual runs spmv_pull and gives the bitmap plan's
    frontier, and a BFS that is not structure-only (no plan) runs. The
    PUSHONLY push gives the same frontier, and PUSHPULL, from the source
    alone (push preferred), pushes it and equals the JAX PUSHPULL
    mxv_dual: dense image, count, used_push, use_sparse and ratio."""
    from graphblast_tpu.algorithms.bfs import (
        _initial_frontier as jax_initial_frontier)
    from graphblast_tpu.ops.dispatch import mxv_dual as jax_mxv_dual
    from graphblast_tpu_torch.algorithms.bfs import _initial_frontier
    from graphblast_tpu_torch.ops.dispatch import mxv_dual
    from graphblast_tpu_torch.ops.kernels.bitmap_pull import plan_for_bitmap

    J, T = graphs["chesapeake"]
    f = _initial_frontier(T.nrows, 0, T.device)
    kw = dict(transpose=True, structure_only=True,
              mode=tgb.Direction.PULLONLY)
    f2, _ = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0, **kw)
    f1, _ = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0,
                     pull_plan=plan_for_bitmap(T, transpose=True), **kw)
    assert torch.equal(f2.dense, f1.dense) and int(f2.snvals) > 0
    np.testing.assert_array_equal(
        bfs(T, 0, PULL.replace(structure_only=False)).to_numpy(),
        bfs_cpu(T, 0))
    f3, used_push = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0,
                             **dict(kw, mode=tgb.Direction.PUSHONLY))
    assert used_push and torch.equal(f3.dense, f1.dense)
    assert int(f3.snvals) == int(f1.snvals)
    f4, used_push = mxv_dual(T, f, tgb.LogicalOrAndSemiring, 0.0,
                             **dict(kw, mode=tgb.Direction.PUSHPULL))
    jf, j_push = jax_mxv_dual(J, jax_initial_frontier(T.nrows, 0),
                              jgb.LogicalOrAndSemiring, 0.0,
                              **dict(kw, mode=jgb.Direction.PUSHPULL))
    assert used_push is True and bool(j_push)
    assert torch.equal(f4.dense, f1.dense)
    np.testing.assert_array_equal(f4.dense.numpy(), np.asarray(jf.dense))
    assert int(f4.snvals) == int(jf.snvals) == int(f1.snvals)
    assert bool(f4.use_sparse) == bool(jf.use_sparse)
    assert float(f4.ratio) == float(jf.ratio)


def test_rmat_edges_match_jax():
    from graphblast_tpu.io.rmat import rmat_edges as jedges
    from graphblast_tpu_torch.io.rmat import rmat_edges

    for scale, ef, seed in ((10, 16, 42), (7, 4, 0)):
        for a, b in zip(rmat_edges(scale, ef, seed), jedges(scale, ef, seed)):
            np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda():
    """Without device= the entry points ask for CUDA, and raise where there
    is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without CUDA")
    from graphblast_tpu_torch.io.rmat import grid_matrix, rmat_matrix

    rows, cols, n = _directed_coo()
    with pytest.raises(RuntimeError, match="cuda"):
        tgb.Matrix.from_coo(rows, cols, np.ones(len(rows)), n, n)
    with pytest.raises(RuntimeError, match="cuda"):
        tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"))
    with pytest.raises(RuntimeError, match="cuda"):
        rmat_matrix(6)
    with pytest.raises(RuntimeError, match="cuda"):
        grid_matrix(4)
