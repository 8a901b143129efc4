"""The port's native ingest (`graphblast_tpu_torch.native`, its own
graphio.cpp built with g++ into graphblast_tpu_torch/_build/) against the
JAX package's native library and the port's NumPy path (GRB_NATIVE=0),
a twin of tests/test_native.py. Every comparison is exact: ids, values,
dtypes and sizes."""
import glob
import os

import numpy as np
import pytest

from graphblast_tpu import native as jnative
from graphblast_tpu_torch import native
from graphblast_tpu_torch.io import mmio
from graphblast_tpu_torch.io.rmat import rmat_matrix
from graphblast_tpu_torch.matrix import LEAVES

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MTX = sorted(os.path.basename(p) for p in glob.glob(os.path.join(DATA,
                                                                 "*.mtx")))


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def _numpy_read(path, directed, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("GRB_NATIVE", "0")
        assert native.read_mtx_native(path, directed) is None
        return mmio.read_mtx(path, directed, remove_self_loops=True)


@pytest.mark.parametrize("directed", [0, 1, 2])
@pytest.mark.parametrize("fname", MTX)
def test_read_mtx_native_matches_jax_and_numpy(fname, directed, monkeypatch):
    """The port's read_mtx_native equals the JAX package's and the port's
    NumPy path; read_mtx, which takes the native path, returns the same
    arrays."""
    path = os.path.join(DATA, fname)
    got = native.read_mtx_native(path, directed, remove_self_loops=True)
    assert got is not None
    _equal(got, jnative.read_mtx_native(path, directed,
                                        remove_self_loops=True))
    want = _numpy_read(path, directed, monkeypatch)
    _equal(got, want[:5])
    _equal(mmio.read_mtx(path, directed, remove_self_loops=True)[:5],
           want[:5])


@pytest.mark.parametrize("remove_self_loops", [True, False])
@pytest.mark.parametrize("undirected", [False, True])
def test_canonicalize_native_matches_jax_and_numpy(undirected,
                                                    remove_self_loops,
                                                    monkeypatch):
    rng = np.random.RandomState(1234)
    rows = rng.randint(0, 50, 300).astype(np.int64)
    cols = rng.randint(0, 50, 300).astype(np.int64)
    vals = rng.rand(300)
    got = native.canonicalize_native(rows, cols, vals, undirected,
                                     remove_self_loops)
    _equal(got, jnative.canonicalize_native(rows, cols, vals, undirected,
                                            remove_self_loops))
    with monkeypatch.context() as m:
        m.setenv("GRB_NATIVE", "0")
        assert native.canonicalize_native(rows, cols, vals, undirected,
                                          remove_self_loops) is None
        want = mmio.canonicalize_coo(rows, cols, vals, undirected=undirected,
                                     remove_self_loops=remove_self_loops)
    _equal(got, want)
    # canonicalize_coo takes the native route from NATIVE_MIN entries on
    monkeypatch.setattr(mmio, "NATIVE_MIN", 1)
    _equal(mmio.canonicalize_coo(rows, cols, vals.astype(np.float32),
                                 undirected=undirected,
                                 remove_self_loops=remove_self_loops),
           (want[0], want[1], want[2].astype(np.float32)))


@pytest.mark.parametrize("shape", [(300, 300), (300, 77), (1, 5)])
def test_coo_to_csr_native_matches_jax_and_numpy(shape, monkeypatch):
    rng = np.random.RandomState(0)
    n, ncols = shape
    m = 5000
    rows = rng.randint(0, n, m).astype(np.int64)
    cols = rng.randint(0, ncols, m).astype(np.int64)
    vals = rng.rand(m)
    got = native.coo_to_csr_native(rows, cols, vals, n, ncols)
    _equal(got, jnative.coo_to_csr_native(rows, cols, vals, n, ncols))
    order = np.lexsort((cols, rows))
    want_ptr = np.zeros(n + 1, np.int64)
    np.add.at(want_ptr, rows + 1, 1)
    _equal(got, (np.cumsum(want_ptr), cols[order], vals[order]))
    # mmio.coo_to_csr: the NumPy path, and the native one from NATIVE_MIN
    numpy_path = mmio.coo_to_csr(rows, cols, vals.astype(np.float32), n,
                                 ncols)
    _equal(numpy_path, (got[0], got[1], got[2].astype(np.float32)))
    monkeypatch.setattr(mmio, "NATIVE_MIN", 1)
    _equal(mmio.coo_to_csr(rows, cols, vals.astype(np.float32), n, ncols),
           numpy_path)
    # an id outside the shape: the library refuses it
    assert native.coo_to_csr_native(rows, cols, vals, n - 1 if n > 1 else 0,
                                    ncols) is None


def test_rmat_matrix_with_and_without_the_native_path(monkeypatch):
    """rmat_matrix(12) through the native canonicalize (NATIVE_MIN set
    below its 65,536 raw edges, as rmat18's 4.2 M pass it) equals the
    NumPy path's, leaf by leaf."""
    monkeypatch.setattr(mmio, "NATIVE_MIN", 1)
    got = rmat_matrix(12, device="cpu")
    monkeypatch.setenv("GRB_NATIVE", "0")
    want = rmat_matrix(12, device="cpu")
    assert (got.nrows, got.nvals) == (want.nrows, want.nvals) == (
        4096, want.nvals)
    for leaf in LEAVES:
        a, b = getattr(got, leaf), getattr(want, leaf)
        assert (a is None) == (b is None), leaf
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_library_builds_into_the_ports_build_dir():
    """The .so lands in graphblast_tpu_torch/_build/, under a name that
    hashes its source, never beside the JAX package's library."""
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.basename(os.path.dirname(native.BUILD_DIR)) == (
        "graphblast_tpu_torch")
    assert os.path.exists(path)
    assert os.path.dirname(path) != os.path.dirname(jnative._SO)
    assert native._SRC != jnative._SRC


def test_grb_native_0_turns_the_native_path_off(monkeypatch):
    monkeypatch.setenv("GRB_NATIVE", "0")
    assert native.get_lib() is None
    rows = np.array([1, 0], np.int64)
    assert native.canonicalize_native(rows, rows, rows, True, True) is None
    assert native.coo_to_csr_native(rows, rows, rows, 2, 2) is None
    monkeypatch.setenv("GRB_NATIVE", "false")
    assert native.get_lib() is None


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """A source that does not compile raises with g++'s error, where the
    JAX package's _build quietly falls back."""
    bad = tmp_path / "graphio.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.get_lib()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so*"))
