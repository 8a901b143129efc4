"""The port's local graph clustering (`algorithms/lgc.py`) and its golden
(`reference.lgc_cpu`) against the JAX package's (twins of
tests/test_algorithms2.py:71).

The same graphs, chesapeake and a seeded RMAT graph (made by each
package's own generator from one seed, checked equal), go through the
JAX `lgc` and `lgc_cpu` and the port's on CPU tensors, where the pull's
gathers run K6's plain version. The bar is the JAX test's: rtol 1e-3 and
atol 1e-7.
"""
import os

import numpy as np
import pytest

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import lgc as jax_lgc
from graphblast_tpu.algorithms.reference import lgc_cpu as jax_lgc_cpu
from graphblast_tpu.io.rmat import rmat_matrix as jax_rmat
from graphblast_tpu_torch.algorithms import lgc, lgc_cpu
from graphblast_tpu_torch.algorithms.lgc import _lgc_loop
from graphblast_tpu_torch.io.rmat import rmat_matrix

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
RTOL, ATOL = 1e-3, 1e-7


@pytest.fixture(scope="module")
def graphs():
    path = os.path.join(DATA, "chesapeake.mtx")
    J = jax_rmat(10, 8, seed=3)
    T = rmat_matrix(10, 8, seed=3, device="cpu")
    np.testing.assert_array_equal(T.row_ptr.numpy(), np.asarray(J.row_ptr))
    return {"chesapeake": (jgb.Matrix.from_mtx(path, use_cache=False),
                           tgb.Matrix.from_mtx(path, use_cache=False,
                                               device="cpu")),
            "rmat10": (J, T)}


def _sources(T):
    deg = np.diff(T.host_csr()[0])
    return [0, int(np.argmax(deg))]


@pytest.mark.parametrize("graph", ["chesapeake", "rmat10"])
@pytest.mark.parametrize("which", [0, 1], ids=["vertex0", "hub"])
@pytest.mark.parametrize("eps", [1e-6, 1e-7])
def test_lgc_matches_jax_and_its_golden(graphs, graph, which, eps):
    """The port's lgc equals the JAX lgc and the JAX lgc_cpu within rtol
    1e-3 / atol 1e-7, and the source keeps the most mass."""
    J, T = graphs[graph]
    s = _sources(T)[which]
    got = lgc(T, s, alpha=0.15, eps=eps).to_numpy()
    assert got.dtype == np.float32 and got.shape == (T.nrows,)
    want = np.asarray(jax_lgc(J, s, alpha=0.15, eps=eps).to_numpy())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    gold = jax_lgc_cpu(J, s, alpha=0.15, eps=eps, max_niter=10000)
    np.testing.assert_allclose(got, gold, rtol=RTOL, atol=ATOL)
    assert int(np.argmax(got)) == s


@pytest.mark.parametrize("graph", ["chesapeake", "rmat10"])
def test_lgc_cpu_matches_jax_golden(graphs, graph):
    """The vectorised golden equals the JAX golden's vertex-at-a-time loop
    within rtol 1e-3 / atol 1e-7, at the default max_niter and at 3."""
    J, T = graphs[graph]
    for s in _sources(T):
        for niter in (200, 3):
            np.testing.assert_allclose(
                lgc_cpu(T, s, 0.15, 1e-6, niter),
                jax_lgc_cpu(J, s, 0.15, 1e-6, niter), rtol=RTOL, atol=ATOL)


def test_lgc_stops_at_max_niter_and_counts_iterations(graphs):
    """max_niter bounds the loop; without it the loop runs until the
    frontier empties, one iteration past the last nonempty frontier, as
    JAX's while-loop does."""
    J, T = graphs["chesapeake"]
    p2 = lgc(T, 0, desc=tgb.Descriptor(max_niter=2)).to_numpy()
    np.testing.assert_allclose(
        p2, np.asarray(jax_lgc(J, 0, desc=jgb.Descriptor(
            max_niter=2)).to_numpy()), rtol=RTOL, atol=ATOL)
    _, _, iters = _lgc_loop(T, 0, alpha=0.15, eps=1e-6, max_niter=10000)
    _, _, two = _lgc_loop(T, 0, alpha=0.15, eps=1e-6, max_niter=2)
    assert two == 2 and iters > 2
    with pytest.raises(ValueError, match="CSR"):
        lgc(T.set_storage(tgb.SparseFormat.CSCONLY), 0)
