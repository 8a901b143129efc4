"""Ingest at scale on the CPU: the MatrixMarket writer and coo_to_csc, the
RMAT cache of io/rmat.py, the two tools of graphblast_tpu_torch/tools and
the package exports, against the JAX package.

The same COO, made with NumPy from a seed, goes to both packages. Files
are compared byte for byte, arrays exactly. The cache's scale threshold is
lowered by monkeypatch so that small graphs take it.
"""
import os
import tempfile

import numpy as np
import pytest

import graphblast_tpu as jgb
from graphblast_tpu.io import mmio as jmmio
from graphblast_tpu_torch import io as tio
from graphblast_tpu_torch.io import mmio, rmat
from graphblast_tpu_torch.tools import gen_rmat_cache, mtx_ingest_check


def _coo(seed, n=50, m=400):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    vals = rng.standard_normal(m).astype(np.float32) * 10
    return rows, cols, vals, n


# --------------------------------------------------------------- write_mtx
@pytest.mark.parametrize("chunk", [7, 1 << 22])
@pytest.mark.parametrize("field", ["pattern", "real"])
@pytest.mark.parametrize("seed", [0, 1])
def test_write_mtx_is_byte_equal_to_jax(tmp_path, seed, field, chunk):
    rows, cols, vals, n = _coo(seed)
    mine, theirs = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    mmio.write_mtx(str(mine), rows, cols, vals, n, n + 3, field=field,
                   chunk=chunk)
    jmmio.write_mtx(str(theirs), rows, cols, vals, n, n + 3, field=field,
                    chunk=chunk)
    assert mine.read_bytes() == theirs.read_bytes()


def test_write_mtx_symmetric_and_empty_are_byte_equal(tmp_path):
    rows, cols, vals, n = _coo(2)
    keep = rows >= cols
    for args in ((rows[keep], cols[keep], vals[keep], n, n, "real",
                  "symmetric"),
                 (np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0, np.float32), 4, 4, "pattern", "general")):
        mmio.write_mtx(str(tmp_path / "p.mtx"), *args)
        jmmio.write_mtx(str(tmp_path / "j.mtx"), *args)
        assert ((tmp_path / "p.mtx").read_bytes()
                == (tmp_path / "j.mtx").read_bytes())


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("field", ["pattern", "real"])
@pytest.mark.parametrize("directed", [0, 1, 2])
def test_write_mtx_round_trips_through_read_mtx(tmp_path, monkeypatch,
                                                native, field, directed):
    """write_mtx then read_mtx, native and NumPy, gives the canonical COO
    of what was written (pattern values 1), as the JAX reader does."""
    monkeypatch.setenv("GRB_NATIVE", native)
    rows, cols, vals, n = _coo(3)
    path = str(tmp_path / "g.mtx")
    mmio.write_mtx(path, rows, cols, vals, n, n, field=field)
    r, c, v, nr, nc, info = mmio.read_mtx(path, directed=directed)
    jr, jc, jv, jnr, jnc, _ = jmmio.read_mtx(path, directed=directed)
    assert (nr, nc) == (jnr, jnc) == (n, n) and info.field == field
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    want = mmio.canonicalize_coo(
        rows, cols, np.ones(len(rows)) if field == "pattern"
        else vals.astype(np.float64).astype(np.float32).astype(np.float64),
        undirected=directed == 2, remove_self_loops=True)
    np.testing.assert_array_equal(r, want[0])
    np.testing.assert_array_equal(c, want[1])
    np.testing.assert_allclose(v, want[2], rtol=1e-8)


@pytest.mark.parametrize("seed", [0, 4])
def test_coo_to_csc_equals_jax(seed):
    rows, cols, vals, n = _coo(seed)
    key = np.unique(rows * n + cols, return_index=True)[1]
    rows, cols, vals = rows[key], cols[key], vals[key]
    got = mmio.coo_to_csc(rows, cols, vals, n)
    want = jmmio.coo_to_csc(rows, cols, vals, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (n + 1,) and got[0][-1] == len(rows)


# ------------------------------------------------------------ the RMAT cache
SCALE = 8


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    """The cache threshold lowered to SCALE, its directory a fresh one,
    and every np.load path recorded."""
    monkeypatch.setattr(rmat, "CACHE_MIN_SCALE", SCALE)
    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setenv("GRB_RMAT_CACHE_DIR", str(d))
    monkeypatch.delenv("GRB_RMAT_CACHE", raising=False)
    loaded = []
    real = np.load

    def spy(path, *a, **k):
        loaded.append(os.fspath(path))
        return real(path, *a, **k)

    monkeypatch.setattr(np, "load", spy)
    return d, loaded


def _refuse(*_, **__):
    raise AssertionError("rmat_edges called: the cache was not read")


def _tuples(A):
    return [np.asarray(x) for x in A.extract_tuples()]


def test_rmat_cache_writes_then_reads(cache_env, monkeypatch):
    d, loaded = cache_env
    # the JAX package's file of the same graph, which must never be read
    (d / f".rmat{SCALE}_16_42.npz").write_bytes(b"not an npz")
    first = rmat.rmat_matrix(SCALE, 16, seed=42, device="cpu")
    path = d / f".rmat{SCALE}_16_42.torch.npz"
    assert path.exists() and loaded == []
    with np.load(path) as z:
        assert z["rows"].dtype == np.int32 and z["cols"].dtype == np.int32
        assert z["vals"].dtype == np.float32
    loaded.clear()
    monkeypatch.setattr(rmat, "rmat_edges", _refuse)
    second = rmat.rmat_matrix(SCALE, 16, seed=42, device="cpu")
    assert loaded == [str(path)]
    want = jgb.io.rmat.rmat_matrix(SCALE, 16, seed=42)
    for a, b, w in zip(_tuples(first), _tuples(second), _tuples(want)):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    assert (second.nrows, second.nvals) == (want.nrows, want.nvals)


def test_rmat_cache_off_and_cache_dir(cache_env, monkeypatch, tmp_path):
    d, loaded = cache_env
    monkeypatch.setenv("GRB_RMAT_CACHE", "0")
    rmat.rmat_matrix(SCALE, 16, seed=7, device="cpu")
    assert list(d.iterdir()) == []
    monkeypatch.delenv("GRB_RMAT_CACHE")
    other = tmp_path / "other"
    other.mkdir()
    A = rmat.rmat_matrix(SCALE, 16, seed=7, device="cpu",
                         cache_dir=str(other))
    assert [p.name for p in other.iterdir()] == [f".rmat{SCALE}_16_7.torch.npz"]
    assert list(d.iterdir()) == []
    monkeypatch.setattr(rmat, "rmat_edges", _refuse)
    B = rmat.rmat_matrix(SCALE, 16, seed=7, device="cpu",
                         cache_dir=str(other))
    for a, b in zip(_tuples(A), _tuples(B)):
        np.testing.assert_array_equal(a, b)
    assert loaded == [str(other / f".rmat{SCALE}_16_7.torch.npz")]


def test_rmat_cache_default_dir_is_tmpdir(cache_env, monkeypatch, tmp_path):
    """Without cache_dir and GRB_RMAT_CACHE_DIR the file goes to the
    temporary directory, which TMPDIR names, and is read from there."""
    d, loaded = cache_env
    monkeypatch.delenv("GRB_RMAT_CACHE_DIR")
    tmp = tmp_path / "tmpdir"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", None)  # gettempdir re-reads
    name = f".rmat{SCALE}_16_5.torch.npz"
    assert rmat.cache_path(SCALE, 16, 5) == str(tmp / name)
    A = rmat.rmat_matrix(SCALE, 16, seed=5, device="cpu")
    assert [p.name for p in tmp.iterdir()] == [name]
    monkeypatch.setattr(rmat, "rmat_edges", _refuse)
    B = rmat.rmat_matrix(SCALE, 16, seed=5, device="cpu")
    for a, b in zip(_tuples(A), _tuples(B)):
        np.testing.assert_array_equal(a, b)
    assert loaded == [str(tmp / name)] and list(d.iterdir()) == []


def test_rmat_cache_skips_directed_small_and_unwritable(cache_env,
                                                        monkeypatch):
    """A directed graph, a scale below the threshold and a directory that
    cannot be written build without the cache, as in the JAX package."""
    d, loaded = cache_env
    A = rmat.rmat_matrix(SCALE, 16, seed=3, undirected=False, device="cpu")
    J = jgb.io.rmat.rmat_matrix(SCALE, 16, seed=3, undirected=False)
    for a, w in zip(_tuples(A), _tuples(J)):
        np.testing.assert_array_equal(a, w)
    rmat.rmat_matrix(SCALE - 1, 16, seed=3, device="cpu")
    assert list(d.iterdir()) == []
    C = rmat.rmat_matrix(SCALE, 16, seed=3, device="cpu",
                         cache_dir=str(d / "missing"))
    assert C.nvals > 0 and loaded == []


# ------------------------------------------------------------------- tools
def test_gen_rmat_cache_main(cache_env, monkeypatch, capsys):
    d, _ = cache_env
    assert gen_rmat_cache.main([str(SCALE), str(SCALE + 1)]) == 0
    out = capsys.readouterr().out
    assert out.count("[gen] wrote") == 2
    for scale in (SCALE, SCALE + 1):
        path = rmat.cache_path(scale, 16, 42)
        assert os.path.dirname(path) == str(d) and os.path.exists(path)
        got = rmat.load_coo(path)
        r, c = jgb.io.rmat.rmat_edges(scale, 16, 42)
        want = jmmio.canonicalize_coo(r, c, np.ones(len(r), np.float32),
                                      undirected=True, remove_self_loops=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [a.dtype for a in got] == [np.int32, np.int32, np.float32]
    # an existing file is left as it is; rmat_matrix reads it
    assert gen_rmat_cache.main([str(SCALE)]) == 0
    assert "exists: skipped" in capsys.readouterr().out
    monkeypatch.setattr(rmat, "rmat_edges", _refuse)
    A = rmat.rmat_matrix(SCALE, 16, seed=42, device="cpu")
    J = jgb.io.rmat.rmat_matrix(SCALE, 16, seed=42)
    for a, w in zip(_tuples(A), _tuples(J)):
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("skip_python", [False, True])
def test_mtx_ingest_check_main(tmp_path, capsys, skip_python):
    out = tmp_path / "g.mtx"
    argv = ["--scale", "9", "--out", str(out), "--keep"]
    assert mtx_ingest_check.main(argv + (["--skip-python"] if skip_python
                                         else [])) == 0
    text = capsys.readouterr().out
    assert ("[parity] native == python: OK" in text) != skip_python
    rows, cols = rmat.rmat_edges(9, 16, 42)
    jpath = tmp_path / "j.mtx"
    jmmio.write_mtx(str(jpath), rows, cols, None, 512, 512, field="pattern")
    assert out.read_bytes() == jpath.read_bytes()
    assert mtx_ingest_check.main(["--scale", "8"]) == 0


def test_mtx_ingest_check_reports_a_mismatch(monkeypatch, capsys):
    """A difference between the parsers exits 1."""
    real = mmio.read_mtx

    def off_by_one(*a, **k):
        r, c, v, nr, nc, info = real(*a, **k)
        return r, c, v + 1, nr, nc, info

    monkeypatch.setattr(mmio, "read_mtx", off_by_one)
    assert mtx_ingest_check.main(["--scale", "8"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


# ----------------------------------------------------------------- exports
def test_exports_match_jax():
    for name in ("mmio", "cache", "rmat"):
        assert hasattr(tio, name) and hasattr(jgb.io, name)
    from graphblast_tpu.algorithms import mis_inner as jmis_inner
    from graphblast_tpu_torch.algorithms import mis_inner
    from graphblast_tpu_torch.algorithms.mis import mis_inner as own

    assert mis_inner is own and callable(jmis_inner)
