"""The port's core modules against the JAX package: types, semiring catalog,
descriptor, ingest (mmio, cache), Matrix, Vector and the dispatch's
direction heuristic (graphblast_tpu_torch). Inputs come from NumPy; every
comparison is exact except where a float op is compared, and there the
float32 results must be equal too (both packages compute in float32).
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu import semiring as jsr
from graphblast_tpu_torch import semiring as tsr

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MTX = sorted(glob.glob(os.path.join(DATA, "*.mtx")))


@pytest.mark.parametrize("pair", list(zip(jsr.ALL_SEMIRINGS,
                                          tsr.ALL_SEMIRINGS)),
                         ids=[s.name for s in jsr.ALL_SEMIRINGS])
def test_semiring_matches_jax(pair):
    """Names, identities (quirks included) and ⊕/⊗ on sample values."""
    js, ts = pair
    assert (js.name, js.add.name, js.mul.name) == (ts.name, ts.add.name,
                                                   ts.mul.name)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.int32, torch.int32),
                     (jnp.bool_, torch.bool)):
        assert ts.identity(tdt).dtype == tdt
        assert ts.identity(tdt).item() == js.identity(jdt).item(), tdt
    a = np.array([0.0, 1.0, 2.5, -3.0, 7.0], np.float32)
    b = np.array([0.0, 4.0, -1.5, 2.0, 7.0], np.float32)
    if ts.mul.name == "divides":
        b[b == 0] = 1.0
    for jop, top in ((js.add_op, ts.add_op), (js.mul_op, ts.mul_op)):
        want = np.asarray(jop(jnp.asarray(a), jnp.asarray(b)))
        got = top(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_binary_op_catalog_matches_jax():
    assert ([o.name for o in tsr.ALL_BINARY_OPS]
            == [o.name for o in jsr.ALL_BINARY_OPS])
    assert ([m.name for m in tsr.ALL_MONOIDS]
            == [m.name for m in jsr.ALL_MONOIDS])
    a = np.array([0, 1, 3, -2], np.int32)
    for jop, top in zip(jsr.ALL_BINARY_OPS, tsr.ALL_BINARY_OPS):
        if top.name == "divides":
            continue
        want = np.asarray(jop(jnp.asarray(a), jnp.asarray(a[::-1].copy())))
        got = top(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=top.name)


def test_descriptor_matches_jax():
    for name in ("DEFAULT", "BFS_TUNED"):
        jd, td = getattr(jgb, name), getattr(tgb, name)
        for field in ("mask_scmp", "structure_only", "switchpoint",
                      "memusage", "earlyexit", "opreuse", "sort_push",
                      "max_niter", "timing", "seed"):
            assert getattr(td, field) == getattr(jd, field), (name, field)
        assert td.mxv_mode.name == jd.mxv_mode.name == "PUSHPULL"
        assert td.load_balance.name == jd.load_balance.name
    assert tgb.BFS_TUNED.toggle_mask().mask_scmp
    assert tgb.types.round_up(1025, 1024) == jgb.types.round_up(1025, 1024)


@pytest.mark.parametrize("path", MTX, ids=[os.path.basename(p) for p in MTX])
def test_read_mtx_matches_jax(path):
    from graphblast_tpu.io import mmio as jmmio
    from graphblast_tpu_torch.io import mmio

    for directed in (0, 1, 2):
        want = jmmio.read_mtx(path, directed=directed)
        got = mmio.read_mtx(path, directed=directed)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3:5] == want[3:5]


def test_cache_writes_its_own_sidecar(tmp_path):
    from graphblast_tpu_torch.io import cache

    src = tmp_path / "g.mtx"
    src.write_text(open(os.path.join(DATA, "chesapeake.mtx")).read())
    first = cache.read_mtx_cached(str(src))
    side = cache.cache_path(str(src), True, True)
    assert os.path.basename(side) == ".g.ud.nosl.torch.npz"
    assert os.path.exists(side)
    assert [p.name for p in tmp_path.iterdir()
            if p.name.endswith(".tmp")] == []
    again = cache.read_mtx_cached(str(src))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["CSRCSC", "CSRONLY", "CSCONLY"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_arrays_match_jax(fmt, symmetric):
    from graphblast_tpu_torch.matrix import LEAVES

    rng = np.random.default_rng(5)
    n, m = 300, 2000
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    if symmetric:
        rows, cols = np.r_[rows, cols], np.r_[cols, rows]
    rows, cols, vals = jgb.io.mmio.canonicalize_coo(
        rows, cols, rng.random(len(rows)), undirected=False,
        remove_self_loops=True)
    if symmetric:   # symmetric values too, so CSC == CSR
        vals = np.ones(len(rows))
    J = jgb.Matrix.from_coo(rows, cols, vals, n, n,
                            fmt=getattr(jgb.SparseFormat, fmt))
    T = tgb.Matrix.from_coo(rows, cols, vals, n, n,
                            fmt=getattr(tgb.SparseFormat, fmt), device="cpu")
    assert (T.format.name, T.symmetric, T.nvals, T.nnz_pad) == (
        J.format.name, J.symmetric, J.nvals, J.nnz_pad)
    for k in LEAVES:
        j, t = getattr(J, k), getattr(T, k)
        assert (j is None) == (t is None), k
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=k)
    for side in ("_host_csr", "_host_csc"):
        t, j = getattr(T, side), getattr(J, side, None)
        assert (t is None) == (j is None), side
        # host values are kept in the Matrix dtype here
        for a, b in zip(t or (), j or ()):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


def test_vector_conversions_match_jax():
    from graphblast_tpu import vector as jv
    from graphblast_tpu_torch import vector as tv

    rng = np.random.default_rng(9)
    x = np.where(rng.random(500) < 0.1, rng.random(500), 0).astype(np.float32)
    js, jval, jn = jv.sparse_from_dense(jnp.asarray(x), 0.0)
    ts, tval, tn = tv.sparse_from_dense(torch.from_numpy(x), 0.0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    assert int(tn) == int(jn)
    back = tv.dense_from_sparse(500, ts, tval, tn, 0.0)
    np.testing.assert_array_equal(back.numpy(), x)
    want = np.asarray(jv.dense_from_sparse(500, js, jval, jn, -1.0))
    np.testing.assert_array_equal(
        tv.dense_from_sparse(500, ts, tval, tn, -1.0).numpy(), want)
    sp = tgb.Vector(500, tgb.Storage.SPARSE, sind=ts, sval=tval, snvals=tn)
    np.testing.assert_array_equal(sp.to_numpy(), x)


@pytest.mark.parametrize("mode", ["PUSHPULL", "PULLONLY", "PUSHONLY"])
def test_update_direction_matches_jax(mode):
    from graphblast_tpu.ops.dispatch import update_direction as jud
    from graphblast_tpu_torch.ops.dispatch import update_direction as tud

    n = 1000
    for nv, prev_ratio, prev_sparse in ((5, 0.001, True), (50, 0.001, True),
                                        (50, 0.2, False), (5, 0.2, False),
                                        (20, 0.02, True)):
        ju, jr = jud(jnp.asarray(nv, jnp.int32), n, jnp.float32(prev_ratio),
                     jnp.asarray(prev_sparse), 0.01,
                     getattr(jgb.Direction, mode))
        tu, tr = tud(torch.tensor(nv, dtype=torch.int32), n,
                     torch.tensor(prev_ratio), torch.tensor(prev_sparse),
                     0.01, getattr(tgb.Direction, mode))
        assert bool(tu) == bool(ju) and float(tr) == float(jr)


def test_dual_frontier_images_agree():
    from graphblast_tpu_torch.ops.dispatch import DualFrontier

    x = torch.tensor([0.0, 2.0, 0.0, 5.0])
    f = DualFrontier.from_dense(x, 0.0)
    assert int(f.snvals) == 2 and f.sind.tolist()[:2] == [1, 3]
    g = DualFrontier.from_sparse(4, f.sind, f.sval, f.snvals, 0.0)
    assert torch.equal(g.dense, x) and bool(g.use_sparse)


@pytest.mark.parametrize("memusage", [1.0, 0.5, 0.001])
def test_edge_cap_for_matches_jax(memusage):
    from graphblast_tpu.algorithms.common import edge_cap_for as jcap
    from graphblast_tpu_torch.algorithms.common import edge_cap_for as tcap

    rows, cols = np.arange(5000) % 700, np.arange(5000) // 7
    J = jgb.Matrix.from_coo(rows, cols, np.ones(5000), 700, 715)
    T = tgb.Matrix.from_coo(rows, cols, np.ones(5000), 700, 715,
                            device="cpu")
    assert (tcap(T, tgb.Descriptor(memusage=memusage))
            == jcap(J, jgb.Descriptor(memusage=memusage)))
