"""The port's Matrix build (`Matrix.from_coo`, `from_device_coo`,
`from_device_csr`) against the JAX package's `Matrix.from_coo`.

The same seeded NumPy triplets build a JAX Matrix and a port Matrix on the
CPU, in (col, row) order as `canonicalize_coo` gives them, in (row, col)
order, sorted by column alone, and shuffled. Every leaf is held equal with
`np.testing.assert_array_equal`, with nvals, the format, the symmetric flag
and both host copies. The port's passes run a chunk of `matrix._CHUNK`
entries at a time; the cases run at the default chunk and at a chunk of 7
entries, so every pass crosses chunk boundaries.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu_torch import matrix as tmatrix
from graphblast_tpu_torch.io.mmio import canonicalize_coo
from graphblast_tpu_torch.io.rmat import rmat_edges
from graphblast_tpu_torch.tools import build_memory

# "col only": sorted by column, the rows of a column shuffled, which no
# orientation may take as it is
ORDERS = ("csc", "csr", "col only", "shuffled")
KINDS = ("symmetric", "asymmetric", "duplicates", "self-loops", "empty",
         "one entry")
FMTS = ("CSRCSC", "CSRONLY", "CSCONLY")
# (id dtype, pad_to, chunk): None keeps matrix._CHUNK
SETUPS = ((np.int32, 1024, None), (np.int64, 64, 7), (np.int32, 64, 7),
          (np.int64, 1024, None))


def _triplets(kind, rng, n=30):
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(
            0, np.float32)
    if kind == "one entry":
        return np.array([3]), np.array([17]), np.array([2.5], np.float32)
    r, c = rng.integers(0, n, 120), rng.integers(0, n, 120)
    if kind == "symmetric":
        key = np.unique(np.concatenate([r * n + c, c * n + r]))
        r, c = key // n, key % n
        # the values of (r, c) and (c, r) agree
        v = ((np.minimum(r, c) * 7 + np.maximum(r, c)) % 5).astype(
            np.float32)
        return r, c, v
    if kind in ("asymmetric", "self-loops"):
        if kind == "self-loops":
            r[::4] = c[::4]
        key = np.unique(r * n + c)
        r, c = key // n, key % n
    # duplicates keep both copies, in the order they come
    return r, c, rng.standard_normal(len(r)).astype(np.float32)


def _ordered(r, c, v, order, rng):
    if order == "csc":
        perm = np.lexsort((r, c))
    elif order == "csr":
        perm = np.lexsort((c, r))
    elif order == "col only":
        perm = np.lexsort((rng.random(len(r)), c))
    else:
        perm = rng.permutation(len(r))
    return r[perm], c[perm], v[perm]


def _same(J, T):
    """Every leaf exactly, the counts, the format, the symmetric flag and
    both host copies."""
    assert (T.nrows, T.ncols, T.nvals) == (J.nrows, J.ncols, J.nvals)
    assert T.format.name == J.format.name
    assert T.symmetric == J.symmetric
    for leaf in tmatrix.LEAVES:
        a, b = getattr(J, leaf), getattr(T, leaf)
        assert (a is None) == (b is None), leaf
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert b.dtype == a.dtype, leaf
            np.testing.assert_array_equal(b, a, err_msg=leaf)
    for side in ("csr", "csc"):
        want = getattr(J, f"_host_{side}", None)
        got = getattr(T, f"host_{side}")()
        assert (want is None) == (got is None), side
        for a, b in zip(want or (), got or ()):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=side)


@pytest.fixture
def chunk(monkeypatch):
    def set_chunk(entries):
        if entries is not None:
            monkeypatch.setattr(tmatrix, "_CHUNK", entries)
    return set_chunk


@pytest.mark.parametrize("setup", SETUPS, ids=lambda s: f"{s[0].__name__}"
                         f"-pad{s[1]}-chunk{s[2]}")
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
def test_from_coo_equals_jax(order, kind, fmt, setup, chunk):
    id_dtype, pad_to, entries = setup
    chunk(entries)
    rng = np.random.default_rng(len(kind) * 31 + len(order))
    r, c, v = _ordered(*_triplets(kind, rng), order, rng)
    r, c = r.astype(id_dtype), c.astype(id_dtype)
    n = 30
    J = jgb.Matrix.from_coo(r, c, v, n, n, fmt=getattr(jgb.SparseFormat, fmt),
                            pad_to=pad_to)
    T = tgb.Matrix.from_coo(r, c, v, n, n, fmt=getattr(tgb.SparseFormat, fmt),
                            pad_to=pad_to, device="cpu")
    _same(J, T)
    D = tgb.Matrix.from_device_coo(torch.from_numpy(r), torch.from_numpy(c),
                                   torch.from_numpy(v), n, n,
                                   fmt=getattr(tgb.SparseFormat, fmt),
                                   pad_to=pad_to)
    for leaf in tmatrix.LEAVES:
        a, b = getattr(T, leaf), getattr(D, leaf)
        assert (a is None) == (b is None), leaf
        if a is not None:
            assert torch.equal(a, b), leaf
    assert (D.format, D.symmetric) == (T.format, T.symmetric)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(12, 40), (40, 12)])
def test_rectangular_equals_jax(order, shape, chunk):
    """A rectangular matrix is never symmetric, and keeps both
    orientations' own pointers."""
    chunk(7)
    rng = np.random.default_rng(shape[0])
    nr, nc = shape
    key = np.unique(rng.integers(0, nr * nc, 150))
    r, c, v = _ordered(key // nc, key % nc,
                       rng.standard_normal(len(key)).astype(np.float32),
                       order, rng)
    _same(jgb.Matrix.from_coo(r, c, v, nr, nc),
          tgb.Matrix.from_coo(r, c, v, nr, nc, device="cpu"))


@pytest.mark.parametrize("vdtype", ["int32", "float64"])
@pytest.mark.parametrize("order", ORDERS)
def test_value_dtypes_equal_jax(vdtype, order):
    """int32 values kept as int32, and float64 values built as float32:
    the symmetry test compares the values in their own dtype, as JAX's
    does, so two float64 values that round to one float32 keep the Matrix
    asymmetric. The port's host copies hold the leaves' dtype."""
    rng = np.random.default_rng(5)
    n = 20
    key = np.unique(rng.integers(0, n * n, 60))
    r, c = key // n, key % n
    key = np.unique(np.concatenate([r * n + c, c * n + r]))
    r, c = key // n, key % n
    if vdtype == "int32":
        v = (r * c % 7 - 3).astype(np.int32)
        dt = (jgb.Matrix.from_coo, dict(dtype=np.int32),
              dict(dtype=torch.int32))
    else:
        v = np.ones(len(r)) + np.where(r < c, 1e-12, 0.0)
        dt = (jgb.Matrix.from_coo, {}, {})
    r, c, v = _ordered(r, c, v, order, rng)
    J = dt[0](r, c, v, n, n, **dt[1])
    T = tgb.Matrix.from_coo(r, c, v, n, n, device="cpu", **dt[2])
    assert T.symmetric == J.symmetric == (vdtype == "int32")
    for leaf in tmatrix.LEAVES:
        a, b = getattr(J, leaf), getattr(T, leaf)
        assert (a is None) == (b is None), leaf
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=leaf)
            assert b.numpy().dtype == np.asarray(a).dtype
    for side in ("csr", "csc"):
        for a, b in zip(getattr(J, f"_host_{side}"),
                        getattr(T, f"host_{side}")()):
            np.testing.assert_array_equal(b, np.asarray(a).astype(b.dtype))


@pytest.mark.parametrize("scale", [6, 9])
def test_canonical_rmat_equals_jax(scale, chunk):
    """The RMAT path: canonicalize_coo's (col, row)-ordered symmetric
    graph, built over chunks of 7 and 4096 entries."""
    r, c = rmat_edges(scale, 16, 3)
    r, c, v = canonicalize_coo(r, c, np.ones(len(r), np.float32),
                               undirected=True, remove_self_loops=True)
    n = 1 << scale
    J = jgb.Matrix.from_coo(r, c, v, n, n)
    for entries in (7, 4096):
        chunk(entries)
        T = tgb.Matrix.from_coo(r.astype(np.int32), c.astype(np.int32), v,
                                n, n, device="cpu")
        _same(J, T)
        assert T.symmetric and T.col_ind is T.csc_row_ind
        assert T.host_csc()[1] is T.host_csr()[1]


def test_canonical_symmetric_input_takes_one_sort(monkeypatch):
    """A canonical symmetric input is in CSC order already: its build
    sorts once, the CSR's stable int32 sort of the (one) chunk."""
    r, c = rmat_edges(8, 16, 1)
    r, c, v = canonicalize_coo(r, c, np.ones(len(r), np.float32),
                               undirected=True, remove_self_loops=True)
    calls = []
    real = torch.sort

    def counted(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(torch, "sort", counted)
    T = tgb.Matrix.from_coo(r, c, v, 256, 256, device="cpu")
    assert T.symmetric and calls == [torch.int32]


def test_build_steps_in_order():
    """The `steps` callback hears each step as it ends: the sorted input
    builds only the CSR, a shuffled one both orientations."""
    rng = np.random.default_rng(2)
    r, c, v = _ordered(*_triplets("asymmetric", rng), "csc", rng)
    seen = []
    tgb.Matrix.from_coo(r, c, v, 30, 30, device="cpu", steps=seen.append)
    assert seen == ["copy", "order test", "csr", "symmetry test", "cast",
                    "host copies"]
    seen.clear()
    r, c, v = _ordered(r, c, v, "shuffled", rng)
    tgb.Matrix.from_coo(r, c, v, 30, 30, device="cpu", steps=seen.append)
    assert seen == ["copy", "order test", "csc", "csr", "symmetry test",
                    "cast", "host copies"]


def test_index_range_and_ids_outside_shape_raise():
    with pytest.raises(ValueError, match="int32"):
        tgb.Matrix.from_coo([0], [0], [1.0], 2 ** 31, 4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tgb.Matrix.from_coo([0, 5], [1, 2], [1.0, 2.0], 4, 4, device="cpu")


@pytest.mark.parametrize("source", ["numpy", "tensor"])
@pytest.mark.parametrize("side", ["rows", "cols"])
def test_int64_ids_past_int32_raise(source, side):
    """An int64 id of 2^32 + 1 would wrap to 1 in the int32 buffers, inside
    the shape: from_coo (NumPy ids) and from_device_coo (tensor ids) raise
    instead."""
    ids = {"rows": np.array([0, 2], np.int64),
           "cols": np.array([1, 2], np.int64)}
    ids[side][1] = 2 ** 32 + 1
    vals = np.array([1.0, 2.0], np.float32)
    with pytest.raises(ValueError, match="outside"):
        if source == "numpy":
            tgb.Matrix.from_coo(ids["rows"], ids["cols"], vals, 4, 4,
                                device="cpu")
        else:
            tgb.Matrix.from_device_coo(torch.from_numpy(ids["rows"]),
                                       torch.from_numpy(ids["cols"]),
                                       torch.from_numpy(vals), 4, 4)


@pytest.mark.parametrize("kind", ["asymmetric", "duplicates", "symmetric"])
@pytest.mark.parametrize("shuffle_rows", [False, True])
def test_from_device_csr_equals_jax(kind, shuffle_rows, chunk):
    """from_device_csr from JAX's CSR tensors: the same CSR leaves, and a
    CSC equal to JAX's from_coo CSC (a stable sort by column of the CSR,
    so equal entries keep their order), whether or not the ids within a
    row ascend."""
    chunk(7)
    rng = np.random.default_rng(len(kind))
    r, c, v = _ordered(*_triplets(kind, rng), "shuffled", rng)
    J = jgb.Matrix.from_coo(r, c, v, 30, 30)
    ptr, ind, val = (np.array(J.row_ptr), np.array(J.col_ind),
                     np.array(J.val))
    if shuffle_rows:
        # reverse each row: the CSC must still come out (col, row) ordered
        for i in range(30):
            ind[ptr[i]:ptr[i + 1]] = ind[ptr[i]:ptr[i + 1]][::-1].copy()
            val[ptr[i]:ptr[i + 1]] = val[ptr[i]:ptr[i + 1]][::-1].copy()
    T = tgb.Matrix.from_device_csr(torch.from_numpy(ptr),
                                   torch.from_numpy(ind),
                                   torch.from_numpy(val), 30, 30)
    assert T.format.name == "CSRCSC" and not T.symmetric
    np.testing.assert_array_equal(T.row_ptr.numpy(), np.asarray(J.row_ptr))
    np.testing.assert_array_equal(T.row_ind.numpy(), np.asarray(J.row_ind))
    np.testing.assert_array_equal(T.col_ind.numpy(), ind)
    np.testing.assert_array_equal(T.val.numpy(), val)
    if kind == "duplicates" and shuffle_rows:
        return   # reversed rows reverse equal entries' order too
    for leaf in tmatrix.LEAVES[4:]:
        np.testing.assert_array_equal(getattr(T, leaf).numpy(),
                                      np.asarray(getattr(J, leaf)),
                                      err_msg=leaf)


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 12),
       m=st.integers(0, 50), sym=st.booleans(),
       order=st.sampled_from(ORDERS), chunk=st.sampled_from([3, 1 << 24]),
       fmt=st.sampled_from(FMTS))
def test_fuzz_random_coo_equals_jax(seed, n, m, sym, order, chunk, fmt):
    """Random COO, with duplicates, self-loops and small integer values
    so that symmetric graphs come up, built by both packages."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    v = rng.integers(0, 3, m).astype(np.float32)
    if sym:
        r, c, v = (np.concatenate([r, c]), np.concatenate([c, r]),
                   np.concatenate([v, v]))
    r, c, v = _ordered(r, c, v, order, rng)
    old = tmatrix._CHUNK
    tmatrix._CHUNK = chunk
    try:
        T = tgb.Matrix.from_coo(r, c, v, n, n,
                                fmt=getattr(tgb.SparseFormat, fmt),
                                device="cpu")
    finally:
        tmatrix._CHUNK = old
    _same(jgb.Matrix.from_coo(r, c, v, n, n,
                              fmt=getattr(jgb.SparseFormat, fmt)), T)


def test_build_memory_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        build_memory.main(["8"])
