"""The port's direction switch (PUSHPULL `mxv_dual`), the default BFS and
SSSP that run it, and `diameter`, against the JAX package.

The same inputs, made with NumPy from a seed, go to both packages; the
port runs on CPU tensors, so its kernels take their plain versions, and
the JAX package runs as it does off the TPU (no Pallas kernel is on these
paths there). Every comparison is exact (tolerance 0): BFS levels, counts
and directions are integers or bools, SSSP distances are float32 minima of
sums of small integers, which are exact in any order, and the MinimumPlus
products of the mxv_dual ladder are float32 sums of one term each.

The port keeps both frontier images valid every call: the JAX package's
opt-in one-image protocol (GRB_LAZY_FRONTIER=1) is not ported, and the
variable changes nothing here. So `mxv_dual` is held to JAX's in its
default protocol.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.algorithms import bfs as jax_bfs
from graphblast_tpu.algorithms import diameter as jax_diameter
from graphblast_tpu.algorithms import sssp as jax_sssp
from graphblast_tpu.ops import dispatch as jdisp
from graphblast_tpu_torch.algorithms import (bfs, bfs_cpu, diameter, sssp,
                                             sssp_cpu)
from graphblast_tpu_torch.ops import dispatch as tdisp

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
MAXF = float(np.finfo(np.float32).max)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return None if x is None else np.asarray(x)


def _carry(J):
    """The port's Matrix over the JAX Matrix's arrays."""
    arrays = {k: _np(getattr(J, k)) for k in tgb.matrix.LEAVES}
    return tgb.Matrix.from_numpy_arrays(arrays, J.nrows, J.ncols, J.nvals,
                                        J.symmetric, device="cpu")


def _directed(weights: str, n=3000, m=25000, seed=7):
    """A seeded directed graph, unique edges: unit weights, or integer
    weights 1..5 (exact float32 sums)."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n, m).astype(np.int64) * n
                    + rng.integers(0, n, m))
    rows, cols = key // n, key % n
    vals = (np.ones(len(key)) if weights == "unit"
            else rng.integers(1, 6, len(key))).astype(np.float32)
    J = jgb.Matrix.from_coo(rows, cols, vals, n, n)
    return J, _carry(J)


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
    if name == "grid16":
        from graphblast_tpu.io.rmat import grid_matrix as jgrid
        from graphblast_tpu_torch.io.rmat import grid_matrix

        return jgrid(16), grid_matrix(16, device="cpu")
    if name == "directed":
        return _directed("unit")
    if name == "directed_int":
        return _directed("int")
    raise KeyError(name)


NAMES = ["chesapeake", "rmat10", "grid16", "directed", "directed_int"]


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in NAMES}


def _hub(T):
    return int(np.argmax(np.diff(T.host_csr()[0])))


# ------------------------------------------------------- mxv_dual ladder
# frontier densities that rise across switchpoint 0.01 and fall back: the
# heuristic switches only when the ratio crosses it in its direction
LADDER = [0.001, 0.004, 0.02, 0.06, 0.03, 0.012, 0.008, 0.002]
LADDER_CASES = [
    # (name, semiring, structure_only, masked, postprocess)
    ("bfs", "LogicalOrAndSemiring", True, True, False),
    ("bfs_nomask", "LogicalOrAndSemiring", True, False, False),
    ("sssp", "MinimumPlusSemiring", False, False, True),
    ("sssp_mask", "MinimumPlusSemiring", False, True, True),
]


def _ladder_kwargs(struc, masked, post, v, dist, transpose):
    """The keyword arguments of one mxv_dual call for each package: the
    complemented mask v, and SSSP's filter against the distances `dist`
    with its sparse twin."""
    kw = dict(transpose=transpose, mask_scmp=True, structure_only=struc,
              mode=jgb.Direction.PUSHPULL)
    jkw = dict(kw, mask_dense=jnp.asarray(v) if masked else None)
    tkw = dict(kw, mode=tgb.Direction.PUSHPULL,
               mask_dense=_t(v) if masked else None)
    if post:
        jd, td = jnp.asarray(dist), _t(dist)
        jkw.update(postprocess=lambda y: jnp.where(y < jd, y, MAXF),
                   postprocess_sparse=lambda k, x: jnp.where(
                       x < jd[k], x, MAXF))
        tkw.update(postprocess=lambda y: torch.where(y < td, y, MAXF),
                   postprocess_sparse=lambda k, x: torch.where(
                       x < td[k.long()], x, MAXF))
    return jkw, tkw


def _same_frontier(tf, jf, n_out):
    """Dense image, count, sparse image up to the count, use_sparse and
    ratio exactly equal."""
    np.testing.assert_array_equal(tf.dense.numpy(), np.asarray(jf.dense))
    k = int(jf.snvals)
    assert int(tf.snvals) == k
    np.testing.assert_array_equal(tf.sind.numpy()[:k], np.asarray(jf.sind)[:k])
    if jf.sval is not None:
        np.testing.assert_array_equal(tf.sval.numpy()[:k],
                                      np.asarray(jf.sval)[:k])
    assert bool(tf.use_sparse) == bool(jf.use_sparse)
    assert float(tf.ratio) == float(jf.ratio)


@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
@pytest.mark.parametrize("case,sr_name,struc,masked,post", LADDER_CASES,
                         ids=[c[0] for c in LADDER_CASES])
def test_mxv_dual_pushpull_ladder_matches_jax(graphs, case, sr_name, struc,
                                              masked, post, transpose):
    """A ladder of frontier densities across switchpoint, rising then
    falling, each frontier carrying the previous call's ratio and
    direction (the hysteresis state) in both packages: dense, count,
    sparse image, used_push, use_sparse and ratio equal JAX's at every
    step, and both directions run."""
    J, T = graphs["directed_int"]
    rng = np.random.default_rng(31)
    jsr, tsr = getattr(jgb.semiring, sr_name), getattr(tgb.semiring, sr_name)
    ident = float(tsr.identity(torch.float32))
    n = T.nrows
    v = ((rng.random(n) < 0.3) * rng.integers(1, 9, n)).astype(np.float32)
    dist = rng.integers(2, 20, n).astype(np.float32)
    jkw, tkw = _ladder_kwargs(struc, masked, post, v, dist, transpose)
    jprev = tprev = None
    pushed = []
    for density in LADDER:
        x = np.full(n, ident, np.float32)
        pick = rng.random(n) < density
        x[pick] = 1.0 if struc else rng.integers(0, 6, int(pick.sum()))
        jf = jdisp.DualFrontier.from_dense(jnp.asarray(x), ident,
                                           prefer_sparse=True)
        tf = tdisp.DualFrontier.from_dense(_t(x), ident, prefer_sparse=True)
        if jprev is not None:
            jf = dataclasses.replace(jf, ratio=jprev.ratio,
                                     use_sparse=jprev.use_sparse)
            tf = dataclasses.replace(tf, ratio=tprev.ratio,
                                     use_sparse=tprev.use_sparse)
        jprev, j_push = jdisp.mxv_dual(J, jf, jsr, ident, **jkw)
        tprev, t_push = tdisp.mxv_dual(T, tf, tsr, ident, **tkw)
        assert t_push is bool(j_push), density
        _same_frontier(tprev, jprev, n)
        pushed.append(t_push)
    assert True in pushed and False in pushed


@pytest.mark.parametrize("transpose", [True, False], ids=["vxm", "mxv"])
def test_mxv_dual_pushpull_pulls_past_edge_cap(graphs, transpose):
    """A frontier that prefers push but whose degree total exceeds edge_cap
    pulls, as JAX's gate does (where PUSHONLY raises in the port); one
    that fits pushes; both equal JAX's."""
    J, T = graphs["directed_int"]
    n = T.nrows
    x = np.zeros(n, np.float32)
    x[np.random.default_rng(5).choice(n, 40, replace=False)] = 1.0
    ptr = (T.row_ptr if transpose else T.col_ptr).numpy()
    deg_total = int(np.diff(ptr)[x != 0].sum())
    kw = dict(transpose=transpose, structure_only=True)
    for edge_cap, push in ((deg_total - 1, False), (deg_total, True)):
        jf, j_push = jdisp.mxv_dual(
            J, jdisp.DualFrontier.from_dense(jnp.asarray(x), 0.0,
                                             prefer_sparse=True),
            jgb.LogicalOrAndSemiring, 0.0, edge_cap=edge_cap,
            mode=jgb.Direction.PUSHPULL, tier_divisors=(), **kw)
        tf, t_push = tdisp.mxv_dual(
            T, tdisp.DualFrontier.from_dense(_t(x), 0.0, prefer_sparse=True),
            tgb.LogicalOrAndSemiring, 0.0, edge_cap=edge_cap,
            mode=tgb.Direction.PUSHPULL, **kw)
        assert t_push is push and bool(j_push) is push
        _same_frontier(tf, jf, n)
    with pytest.raises(ValueError, match="degree total"):
        tdisp.mxv_dual(T, tdisp.DualFrontier.from_dense(_t(x), 0.0),
                       tgb.LogicalOrAndSemiring, 0.0,
                       edge_cap=deg_total - 1, mode=tgb.Direction.PUSHONLY,
                       **kw)


# ------------------------------------------------------- chains of calls
CHAIN_CASES = [
    # (graph, semiring, structure_only, chains of (source, switchpoint))
    ("rmat10", "LogicalOrAndSemiring", True, ((1, 0.015), (1, 0.002))),
    ("directed_int", "MinimumPlusSemiring", False, ((1, 0.015), (2, 0.015))),
]


def _chain(J, T, jsr, tsr, struc, source, switchpoint):
    """One chain of PUSHPULL mxv_dual calls from `source`, in both
    packages, each call fed the last one's output, BFS-like: the mask is
    the vertices seen so far, complemented (SSSP's filter against the best
    values seen, for MinimumPlus). Checks each step against JAX and
    returns the directions it ran."""
    n = T.nrows
    ident = float(tsr.identity(torch.float32))
    x = np.full(n, ident, np.float32)
    x[source] = 1.0 if struc else 0.0
    jf = jdisp.DualFrontier.from_dense(jnp.asarray(x), ident,
                                       prefer_sparse=True)
    tf = tdisp.DualFrontier.from_dense(_t(x), ident, prefer_sparse=True)
    seen = np.full(n, 0.0 if struc else MAXF, np.float32)
    pushes = []
    for _ in range(16):
        d = tf.dense.numpy()
        ids = np.flatnonzero(d != ident)
        if len(ids) == 0:
            break
        seen[ids] = 1.0 if struc else np.minimum(seen[ids], d[ids])
        jkw, tkw = _ladder_kwargs(struc, struc, not struc, seen.copy(),
                                  seen.copy(), True)
        jf, j_push = jdisp.mxv_dual(J, jf, jsr, ident,
                                    switchpoint=switchpoint, **jkw)
        tf, t_push = tdisp.mxv_dual(T, tf, tsr, ident,
                                    switchpoint=switchpoint, **tkw)
        assert t_push is bool(j_push)
        _same_frontier(tf, jf, n)
        pushes.append(t_push)
    return pushes


@pytest.mark.parametrize("name,sr_name,struc,chains", CHAIN_CASES,
                         ids=[c[0] for c in CHAIN_CASES])
def test_mxv_dual_chain_matches_jax(graphs, name, sr_name, struc, chains):
    """Chains of PUSHPULL mxv_dual calls (`_chain`), each fed the last
    one's output with its hysteresis state: used_push, the dense and
    sparse images, the count, use_sparse and ratio equal JAX's at every
    step, and the chains run both directions and switch between them."""
    J, T = graphs[name]
    jsr, tsr = getattr(jgb.semiring, sr_name), getattr(tgb.semiring, sr_name)
    pushes = [p for source, switchpoint in chains
              for p in _chain(J, T, jsr, tsr, struc, source, switchpoint)]
    assert True in pushes and False in pushes


# --------------------------------------------------------- BFS and SSSP
ALGO = ["chesapeake", "rmat10", "grid16", "directed"]


def _directions(out: str) -> list:
    """The push|pull column of the stepped CSV rows in `out`."""
    return [r.split(", ")[3] for r in out.strip().splitlines()
            if r.count(", ") == 4]


@pytest.mark.parametrize("name", ALGO)
def test_bfs_pushpull_matches_jax(graphs, name, capsys):
    """The default bfs(A, s) (BFS_TUNED, PUSHPULL), fused and stepped, from
    vertex 0 and the hub: levels equal to the JAX bfs and the golden, and
    the stepped CSV's push|pull column equal to JAX's, iteration by
    iteration, with both directions on the RMAT and grid graphs."""
    J, T = graphs[name]
    jdesc = jgb.BFS_TUNED.replace(timing=1)
    tdesc = tgb.BFS_TUNED.replace(timing=1)
    seen = set()
    for s in (0, _hub(T)):
        capsys.readouterr()
        want = np.asarray(jax_bfs(J, s, jdesc, mode="stepped").to_numpy())
        jdirs = _directions(capsys.readouterr().out)
        np.testing.assert_array_equal(want, bfs_cpu(T, s))
        np.testing.assert_array_equal(bfs(T, s).to_numpy(), want)
        got = bfs(T, s, tdesc, mode="stepped").to_numpy()
        np.testing.assert_array_equal(got, want)
        assert _directions(capsys.readouterr().out) == jdirs
        seen.update(jdirs)
    if name in ("rmat10", "grid16"):
        assert seen == {"push", "pull"}


@pytest.mark.parametrize("name", ALGO + ["directed_int"])
def test_sssp_pushpull_matches_jax(graphs, name, capsys):
    """The default sssp(A, s) (DEFAULT, PUSHPULL), fused and stepped, from
    vertex 0 and the hub, on unit weights and (directed_int) integer
    weights: distances equal to the JAX sssp and the golden, and the
    stepped push|pull column equal to JAX's."""
    J, T = graphs[name]
    jdesc = jgb.DEFAULT.replace(timing=1)
    tdesc = tgb.DEFAULT.replace(timing=1)
    for s in (0, _hub(T)):
        capsys.readouterr()
        want = np.asarray(jax_sssp(J, s, jdesc, mode="stepped").to_numpy())
        jdirs = _directions(capsys.readouterr().out)
        np.testing.assert_array_equal(want, sssp_cpu(T, s))
        np.testing.assert_array_equal(sssp(T, s).to_numpy(), want)
        got = sssp(T, s, tdesc, mode="stepped").to_numpy()
        np.testing.assert_array_equal(got, want)
        assert _directions(capsys.readouterr().out) == jdirs


def test_dirinfo_announces_each_switch(graphs, capsys):
    """--dirinfo lines come from used_push: one per iteration, and a
    switch line wherever the direction changes."""
    _, T = graphs["grid16"]
    bfs(T, 0, tgb.BFS_TUNED.replace(timing=1, dirinfo=True), mode="stepped")
    out = capsys.readouterr().out.splitlines()
    dirs = _directions("\n".join(out))
    switches = sum(a != b for a, b in zip(dirs, dirs[1:]))
    assert switches >= 2
    assert sum("->" in r for r in out if r.startswith("[dirinfo]")) == len(
        dirs)
    assert sum("(pull→push)" in r or "(push→pull)" in r
               for r in out) == switches


# -------------------------------------------------------- switchpoints
def _rmat14():
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    return rmat_matrix(14, 16, seed=42, device="cpu")


SWITCH_GRAPHS = [
    # (graph, switchpoint): the grids of tests/test_ops.py's direction
    # tests, and RMAT 14 at switchpoint 0.5, where the hub's second push
    # finds 8,640 vertices and the run switches both ways
    ("grid17", 0.01), ("grid13", 0.01), ("rmat10", 0.01), ("rmat14", 0.5),
]


@pytest.mark.parametrize("name,switchpoint", SWITCH_GRAPHS,
                         ids=[g[0] for g in SWITCH_GRAPHS])
def test_bfs_and_sssp_equal_goldens_at_switchpoints(graphs, capsys, name,
                                                    switchpoint):
    """BFS and SSSP under PUSHPULL at the graph's switchpoint, fused and
    stepped, from the hub: equal to the goldens; on RMAT 14 the stepped
    BFS switches push→pull and pull→push."""
    from graphblast_tpu_torch.io.rmat import grid_matrix

    T = {"grid17": lambda: grid_matrix(17, device="cpu"),
         "grid13": lambda: grid_matrix(13, device="cpu"),
         "rmat10": lambda: graphs["rmat10"][1], "rmat14": _rmat14}[name]()
    s = _hub(T)
    bdesc = tgb.BFS_TUNED.replace(switchpoint=switchpoint, timing=1)
    sdesc = tgb.DEFAULT.replace(switchpoint=switchpoint, timing=1)
    golden = (bfs_cpu(T, s), sssp_cpu(T, s))
    for mode in ("fused", "stepped"):
        capsys.readouterr()
        lv = bfs(T, s, bdesc, mode=mode).to_numpy()
        dirs = _directions(capsys.readouterr().out)
        np.testing.assert_array_equal(lv, golden[0])
        np.testing.assert_array_equal(sssp(T, s, sdesc, mode=mode).to_numpy(),
                                      golden[1])
    assert set(dirs) == {"push", "pull"}
    if name == "rmat14":
        # the stepped BFS switches both ways
        pairs = set(zip(dirs, dirs[1:]))
        assert {("push", "pull"), ("pull", "push")} <= pairs, dirs


def test_lazy_frontier_variable_changes_nothing(graphs, monkeypatch):
    """GRB_LAZY_FRONTIER=1, which opts the JAX package into its one-image
    frontier protocol, changes neither the port's BFS and SSSP results nor
    its push counters: the port reads no such variable."""
    _, T = graphs["rmat10"]
    s = _hub(T)
    counters = ("push_edges", "push_lanes", "top_tier_pushes",
                "bitmap_pushes", "sliced_pushes")

    def run():
        before = [getattr(tdisp.mxv_dual, c) for c in counters]
        out = [bfs(T, s).to_numpy(), sssp(T, s).to_numpy(),
               bfs(T, s, mode="stepped").to_numpy(),
               bfs(T, s, tgb.BFS_TUNED.replace(
                   structure_only=False)).to_numpy()]
        return out, [getattr(tdisp.mxv_dual, c) - b
                     for c, b in zip(counters, before)]

    monkeypatch.delenv("GRB_LAZY_FRONTIER", raising=False)
    want, want_counts = run()
    monkeypatch.setenv("GRB_LAZY_FRONTIER", "1")
    got, got_counts = run()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got_counts == want_counts
    assert want_counts[0] > 0 and want_counts[3] > 0


# -------------------------------------------------------------- diameter
@pytest.mark.parametrize("name,lo,hi", [("chesapeake", 0, 10),
                                        ("grid16", 0, 17)])
def test_diameter_matches_jax(graphs, name, lo, hi):
    """diameter equal to JAX's (eccentricity and source, ties to the first
    source) and to the goldens' largest level − 1."""
    J, T = graphs[name]
    want = jax_diameter(J, lo, hi)
    got = diameter(T, lo, hi)
    assert got == (int(want[0]), int(want[1]))
    eccs = [int(bfs_cpu(T, s).max()) - 1 for s in range(lo, hi)]
    assert got == (max(eccs), lo + int(np.argmax(eccs)))
    assert diameter(T, 3, 3) == (0, -1)
    assert tgb.diameter is diameter
