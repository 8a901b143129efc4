"""Triangle counting on the CPU (graphblast_tpu_torch algorithms/tc.py):
tc, triangle_count and the vectorised golden tc_cpu against the JAX
package's tc on both of its routes (the dense int8 block product below
GRB_TC_DENSE_LIMIT, and the sparse count with the limit set to 0) and its
set-based golden, and the general masked-mxm route of the port against
both. The same COO, made with NumPy from a seed, goes to both packages.
Counts are exact.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import reference as jref
from graphblast_tpu.io.rmat import rmat_edges as jrmat_edges
from graphblast_tpu.io.mmio import canonicalize_coo
from graphblast_tpu_torch.algorithms import reference as tref
from graphblast_tpu_torch.io.rmat import rmat_matrix

# the module (the package's `tc` names the function)
jtc = importlib.import_module("graphblast_tpu.algorithms.tc")
DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")


def _both(rows, cols, n):
    vals = np.ones(len(rows), np.float32)
    return (jgb.Matrix.from_coo(rows, cols, vals, n, n),
            tgb.Matrix.from_coo(rows, cols, vals, n, n, device="cpu"))


def _general_route(L):
    """Σ of mxm(L, L, PlusMultiplies, mask=L, Lᵀ), the reference's route."""
    C = tgb.mxm(L, L, tgb.PlusMultipliesSemiring, mask=L,
                desc=tgb.Descriptor(transpose_inp1=True))
    return int(torch.round(C.val[: C.nvals]).to(torch.int64).sum())


def test_tc_chesapeake():
    path = os.path.join(DATA, "chesapeake.mtx")
    JA = jgb.Matrix.from_mtx(path)
    A = tgb.Matrix.from_mtx(path, device="cpu")
    L = tgb.tril(A)
    got = tgb.algorithms.tc(L)
    assert isinstance(got, int)
    want = jref.tc_cpu(jgb.tril(JA))
    assert got == want == tgb.algorithms.tc_cpu(L)
    assert got == tgb.algorithms.triangle_count(A)
    assert got == jtc.triangle_count(JA) == _general_route(L)


def test_tc_known_triangle():
    # a single triangle 0-1-2 plus a pendant vertex
    pairs = [(0, 1), (0, 2), (1, 2), (2, 3)]
    rows = np.array([a for a, b in pairs] + [b for a, b in pairs])
    cols = np.array([b for a, b in pairs] + [a for a, b in pairs])
    _, A = _both(rows, cols, 4)
    assert tgb.algorithms.triangle_count(A) == 1


@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("scale", [8, 9, 10])
def test_tc_rmat_matches_jax(scale, route, monkeypatch):
    """tc at RMAT scales 8-10 (edge factor 16, seed 42) equal to the JAX tc
    on the route named, to both goldens and to the general mxm route."""
    rows, cols = jrmat_edges(scale, 16, 42)
    r, c, _ = canonicalize_coo(rows, cols, np.ones(len(rows), np.float32),
                               undirected=True, remove_self_loops=True)
    JA, A = _both(r, c, 1 << scale)
    JL, L = jgb.tril(JA), tgb.tril(A)
    if route == "sparse":
        monkeypatch.setenv("GRB_TC_DENSE_LIMIT", "0")
    want = int(jtc.tc(JL))
    assert tgb.algorithms.tc(L) == want
    assert tgb.algorithms.tc_cpu(L) == want == jref.tc_cpu(JL)
    assert _general_route(L) == want


def test_tc_sparse_count_matches_general_route():
    """test_fuzz.py's undirected graph of 200 vertices: tc on the count
    route and the general mxm route equal the goldens."""
    rng = np.random.default_rng(9)
    n, m = 200, 2400
    r, c, _ = canonicalize_coo(rng.integers(0, n, m), rng.integers(0, n, m),
                               np.ones(m, np.float32), undirected=True,
                               remove_self_loops=True)
    JA, A = _both(r, c, n)
    L = tgb.tril(A)
    want = int(jref.tc_cpu(jgb.tril(JA)))
    assert tgb.algorithms.tc(L) == want == tgb.algorithms.tc_cpu(L)
    assert _general_route(L) == want


@pytest.mark.parametrize("case", ["full", "directed", "duplicates", "empty"])
def test_tc_cpu_matches_jax_golden(case):
    """The vectorised golden equals the JAX set-based one on graphs that
    are not a lower triangle: a whole symmetric A, a directed graph, a COO
    with duplicate entries (both goldens count each entry once), and a
    graph with no edges."""
    rng = np.random.default_rng(11)
    n = 60
    rows, cols = rng.integers(0, n, 500), rng.integers(0, n, 500)
    if case == "full":
        rows, cols, _ = canonicalize_coo(rows, cols, np.ones(500),
                                         undirected=True,
                                         remove_self_loops=True)
    elif case == "duplicates":
        rows, cols = np.r_[rows, rows[:100]], np.r_[cols, cols[:100]]
    elif case == "empty":
        rows = cols = np.zeros(0, np.int64)
    JA, A = _both(rows, cols, n)
    want = jref.tc_cpu(JA)
    assert tref.tc_cpu(A) == want
    assert tref.tc_cpu(A, chunk=5) == want


def test_tc_cpu_reads_host_csr_tuples():
    A = rmat_matrix(9, 16, seed=3, device="cpu")
    L = tgb.tril(A)
    ptr, ind, val = L.host_csr()
    assert tref.tc_cpu((ptr, ind, val, L.nrows)) == tgb.algorithms.tc(L)
