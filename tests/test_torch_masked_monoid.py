"""K4's masked entry, SSSP's MinimumPlus pull under its distances, on the CPU.

`spmv_monoid(plan, x, MinimumPlus, bound=b)` promises only what survives
SSSP's filter where(y < b, y, FLT_MAX): its rows with b <= t (t =
`pull_threshold`, min x plus the plan's least weight) keep FLT_MAX, and
the edges whose x is FLT_MAX are skipped. On the CPU its plain version
does the same. Each case holds it, bit for bit, to the unmasked pull
followed by that filter, and its open rows to the unmasked pull itself, on
CSRs with rows in every bin of the row schedule (a row past LONG_ROW
included) and on RMAT, with integer weights in [1, 255], weights with 0
and negatives, and no values. `mxv_dual` with the bound gives the same
DualFrontier as with SSSP's filter as its postprocess, and SSSP over it
the JAX package's distances. The
card's tests (tests/test_torch_cuda.py) take this file's cases, so it
imports JAX only inside the test that needs it.
"""
import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops import dispatch
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp
from graphblast_tpu_torch.ops.kernels import row_schedule as rs

MAXF = mp.FLT_MAX
MP = tgb.MinimumPlusSemiring
T = rs.LONG_ROW


def _every_bin_csr(rng):
    # empty rows, rows of 1-4, 5-8, 9-16 and 17-32 edges, medium rows and
    # one row past LONG_ROW, shuffled so that the schedule reorders them
    lengths = rng.permutation(np.r_[
        np.zeros(40, np.int64), rng.integers(1, 5, 60),
        rng.integers(5, 9, 60), rng.integers(9, 17, 60),
        rng.integers(17, 33, 60), rng.integers(33, 700, 30), [2 * T + 37]])
    n = len(lengths)
    ptr = np.r_[0, np.cumsum(lengths)]
    return n, ptr, rng.integers(0, n, int(ptr[-1]))


def _rmat_csr(rng):
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    ptr, cols, _ = rmat_matrix(10, 16, seed=42, device="cpu").host_csr()
    return len(ptr) - 1, np.asarray(ptr), np.asarray(cols)


CSRS = {"every_bin": _every_bin_csr, "rmat10": _rmat_csr}
WEIGHTS = {
    "int": lambda rng, m: rng.integers(1, 256, m),
    "signed": lambda rng, m: rng.integers(-5, 6, m),
    "unit": lambda rng, m: None,
}
FRONTIERS = ["empty", "whole", "hub", "random"]


def case(csr, weights, seed=13):
    """(n, ptr, cols, vals or None) of a square CSR and its weights; vals
    carry 64 padding entries past ptr[n] that would lower the least weight
    if it were read from them."""
    rng = np.random.default_rng(seed)
    n, ptr, cols = CSRS[csr](rng)
    vals = WEIGHTS[weights](rng, len(cols))
    if vals is not None:
        vals = np.r_[vals, np.full(64, -1e6)].astype(np.float32)
    return n, ptr, cols, vals


def frontier(kind, n, cols, seed=17):
    """x as SSSP's pull sees it: FLT_MAX off the frontier, distances in
    [300, 600) on it; the frontier empty, whole, the column most rows hold
    (a hub) alone, or a random 30%."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(300, 600, n).astype(np.float32)
    on = {"empty": np.zeros(n, bool), "whole": np.ones(n, bool),
          "hub": np.eye(1, n, int(np.bincount(cols, minlength=n).argmax()),
                        dtype=bool)[0],
          "random": rng.random(n) < 0.3}[kind]
    return np.where(on, dist, MAXF).astype(np.float32)


def bound(n, seed=19):
    """SSSP's distances v: a fifth unreached (FLT_MAX), the rest in [0,
    900), so that some rows are settled below t and some open rows keep a
    candidate under their bound and some do not."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.2, MAXF,
                    rng.integers(0, 900, n)).astype(np.float32)


def build(n, ptr, cols, vals, device="cpu"):
    return mp.build_plan_monoid(
        torch.from_numpy(ptr.astype(np.int32)).to(device),
        torch.from_numpy(cols.astype(np.int32)).to(device),
        None if vals is None else torch.from_numpy(vals).to(device), n, n)


def sssp_filter(y, b):
    """SSSP's filter of a pull's candidates against its distances."""
    return torch.where(y < b, y, MAXF)


def check_masked(plan, x, b, y_masked, y_plain):
    """The masked pull's y against the unmasked one's over the same
    inputs: equal after SSSP's filter, equal at every open row, FLT_MAX at
    every closed one."""
    closed = b <= mp.pull_threshold(plan, x)
    assert y_masked.dtype == torch.float32 and y_masked.shape == b.shape
    assert torch.equal(sssp_filter(y_masked, b), sssp_filter(y_plain, b))
    assert torch.equal(y_masked[~closed], y_plain[~closed])
    assert bool((y_masked[closed] == MAXF).all())


@pytest.mark.parametrize("csr", list(CSRS))
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("front", FRONTIERS)
def test_masked_pull_equals_the_filtered_pull(csr, weights, front):
    n, ptr, cols, vals = case(csr, weights)
    plan = build(n, ptr, cols, vals)
    if csr == "every_bin":   # rows in each bin, a long one included
        assert all(r > 0 for r in rs.build_schedule(plan.ptr).bin_rows)
    want_min = 1.0 if vals is None else float(vals[:ptr[-1]].min())
    assert float(plan.w_min) == want_min
    x = torch.from_numpy(frontier(front, n, cols))
    b = torch.from_numpy(bound(n))
    assert mp.takes_bound(plan, MP, b)
    y = mp.spmv_monoid(plan, x, MP, bound=b)
    check_masked(plan, x, b, y, mp.spmv_monoid(plan, x, MP))
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x, MP, b))
    if front == "empty":
        assert bool((y == MAXF).all())
    if front == "whole" and weights == "int":
        # settled rows and open rows that keep a candidate both occur
        t = float(mp.pull_threshold(plan, x))
        assert 0 < int((b <= t).sum()) < n
        assert int((sssp_filter(y, b) < MAXF).sum()) > 0


@pytest.mark.parametrize("csr", list(CSRS))
def test_masked_pull_with_every_row_closed(csr):
    """A bound at t everywhere closes every row: y is FLT_MAX throughout,
    and so is the filtered unmasked pull."""
    n, ptr, cols, vals = case(csr, "int")
    plan = build(n, ptr, cols, vals)
    x = torch.from_numpy(frontier("whole", n, cols))
    b = mp.pull_threshold(plan, x).expand(n).contiguous()
    y = mp.spmv_monoid(plan, x, MP, bound=b)
    assert bool((y == MAXF).all())
    check_masked(plan, x, b, y, mp.spmv_monoid(plan, x, MP))


@pytest.mark.parametrize("b_kind", ["finite", "flt_max", "inf"])
def test_masked_pull_when_t_overflows(b_kind):
    """Weights and distances of 3e38: t = fl(3e38 + 3e38) is +inf, every
    row closes, and every candidate of the unmasked pull clamps to
    FLT_MAX, which the filter keeps only under an infinite bound: both
    give FLT_MAX everywhere."""
    n, ptr, cols, _ = case("every_bin", "unit")
    vals = np.full(len(cols), 3e38, np.float32)
    plan = build(n, ptr, cols, vals)
    x = torch.from_numpy(np.where(frontier("random", n, cols) < MAXF,
                                  np.float32(3e38), MAXF).astype(np.float32))
    assert float(mp.pull_threshold(plan, x)) == float("inf")
    b = {"finite": torch.from_numpy(bound(n)),
         "flt_max": torch.full((n,), MAXF),
         "inf": torch.full((n,), float("inf"))}[b_kind]
    y = mp.spmv_monoid(plan, x, MP, bound=b)
    assert bool((y == MAXF).all())
    assert torch.equal(sssp_filter(y, b),
                       sssp_filter(mp.spmv_monoid(plan, x, MP), b))


@pytest.mark.parametrize("w,exact", [
    (-2.0 ** 102, True), (-2.0 ** 103, False), (-1e38, False),
    (float("nan"), False), (float("-inf"), False), (0.0, True)])
def test_least_weight_gates_the_column_skip(w, exact):
    """A plan whose least weight w makes fl(FLT_MAX + w) round below
    FLT_MAX (at -2^103 the tie goes to the even neighbour, below), or
    that holds a NaN, keeps w_min None: the bound is then ignored and the
    pull is the unmasked one, exactly. Past -2^103 the unmasked pull gives
    an unreached column's edge a candidate under FLT_MAX, which the
    skip would lose."""
    n, ptr, cols, vals = case("every_bin", "int")
    vals[5] = w
    plan = build(n, ptr, cols, vals)
    assert (plan.w_min is not None) == exact
    x = torch.from_numpy(frontier("random", n, cols))
    b = torch.from_numpy(bound(n))
    assert mp.takes_bound(plan, MP, b) == exact
    y = mp.spmv_monoid(plan, x, MP, bound=b)
    y_plain = mp.spmv_monoid(plan, x, MP)
    if exact:
        check_masked(plan, x, b, y, y_plain)
    else:   # a NaN weight's edge is NaN in both
        torch.testing.assert_close(y, y_plain, rtol=0, atol=0,
                                   equal_nan=True)


def test_least_weight_reads_only_the_stored_edges():
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    val = torch.tensor([4.0, 2.5, 7.0, -9.0, float("nan")])
    assert float(mp.least_weight(ptr, val)) == 2.5
    assert float(mp.least_weight(ptr, None)) == 1.0
    assert float(mp.least_weight(torch.zeros(3, dtype=torch.int32),
                                 val)) == 1.0


@pytest.mark.parametrize("name", ["MinimumMultiplies", "MinimumSelectSecond",
                                  "MaximumMultiplies"])
def test_other_semirings_ignore_the_bound(name):
    """Only MinimumPlus takes the masked entry: with any other semiring the
    bound is ignored and the pull is the plain one."""
    n, ptr, cols, vals = case("rmat10", "int")
    plan = build(n, ptr, cols, vals)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    x = torch.from_numpy(frontier("random", n, cols))
    b = torch.from_numpy(bound(n))
    assert not mp.takes_bound(plan, sr, b)
    assert torch.equal(mp.spmv_monoid(plan, x, sr, bound=b),
                       mp.spmv_monoid(plan, x, sr))


def test_masked_pull_refuses_a_bound_it_cannot_read():
    n, ptr, cols, vals = case("rmat10", "int")
    plan = build(n, ptr, cols, vals)
    x = torch.from_numpy(frontier("random", n, cols))
    with pytest.raises(TypeError):
        mp.spmv_monoid(plan, x, MP, bound=torch.zeros(n, dtype=torch.float64))
    with pytest.raises(ValueError):
        mp.spmv_monoid(plan, x, MP, bound=torch.zeros(n + 1))


def _weighted_matrix(weights="int"):
    """rmat10 with the case's weights as a port Matrix, and its COO for
    the JAX package."""
    n, ptr, cols, vals = case("rmat10", weights)
    rows = np.repeat(np.arange(n), np.diff(ptr))
    vals = (np.ones(len(cols), np.float32) if vals is None
            else vals[:len(cols)])
    return (tgb.Matrix.from_coo(rows, cols, vals, n, n, device="cpu"),
            (rows, cols, vals, n))


def _images(f):
    return (f.dense, f.sind, f.sval, f.snvals, f.ratio, f.use_sparse)


def _recording(monkeypatch):
    """Record, for every monoid pull that runs, whether it took the masked
    entry."""
    taken = []
    inner = mp.spmv_monoid_plain

    def record(plan, x, semiring, bound=None):
        taken.append(mp.takes_bound(plan, semiring, bound))
        return inner(plan, x, semiring, bound)

    monkeypatch.setattr(mp, "spmv_monoid_plain", record)
    return taken


@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHPULL"])
def test_mxv_dual_with_the_bound_gives_the_same_frontier(monkeypatch, mode):
    """SSSP's relaxations from rmat10's hub through mxv_dual, once with
    bound = v and once with SSSP's filter as an explicit postprocess: the
    same DualFrontier, image for image, and the same direction, each pull
    with the bound masked and each without it unmasked."""
    A, _ = _weighted_matrix()
    plan = mp.plan_for_monoid(A, transpose=True)
    n = A.nrows
    hub = int(np.argmax(np.diff(A.host_csr()[0])))
    v = torch.full((n,), MAXF)
    v[hub] = 0.0
    f = dispatch.DualFrontier.from_dense(v.clone(), MAXF)
    taken = _recording(monkeypatch)
    kw = dict(transpose=True, mode=getattr(tgb.Direction, mode),
              pull_plan=plan)
    pulls = 0
    while int(f.snvals) > 0:
        del taken[:]
        got, push = dispatch.mxv_dual(A, f, MP, MAXF, bound=v, **kw)
        assert taken == [True] * (not push)
        del taken[:]
        want, push2 = dispatch.mxv_dual(
            A, f, MP, MAXF, postprocess=lambda y: sssp_filter(y, v), **kw)
        assert taken == [False] * (not push)
        assert push == push2
        pulls += not push
        for a, b in zip(_images(got), _images(want)):
            assert (a is None and b is None) or torch.equal(
                torch.as_tensor(a), torch.as_tensor(b))
        torch.minimum(v, got.dense, out=v)
        f = got
    assert pulls >= 2


@pytest.mark.parametrize("post", ["postprocess", "postprocess_sparse"])
def test_mxv_dual_refuses_a_bound_beside_a_postprocess(post):
    """The bound is the call's postprocess: another one beside it is
    refused, not composed."""
    A, _ = _weighted_matrix()
    n = A.nrows
    v = torch.full((n,), MAXF)
    v[0] = 0.0
    f = dispatch.DualFrontier.from_dense(v.clone(), MAXF)
    other = {"postprocess": lambda y: y,
             "postprocess_sparse": lambda k, y: y}[post]
    with pytest.raises(ValueError, match="bound"):
        dispatch.mxv_dual(A, f, MP, MAXF, transpose=True, bound=v,
                          **{post: other})


@pytest.mark.parametrize("weights", ["int", "unit"])
@pytest.mark.parametrize("mode", ["PULLONLY", "PUSHPULL"])
def test_sssp_with_and_without_the_bound_matches_jax(monkeypatch, weights,
                                                     mode):
    """sssp from the first vertex with an edge and from the hub, through
    the masked pull and with the masked entry turned off: equal to each
    other and to the JAX package's distances in the same mode; every pull
    of the first masked."""
    import graphblast_tpu as jgb
    from graphblast_tpu.algorithms import sssp as jax_sssp

    A, (rows, cols, vals, n) = _weighted_matrix(weights)
    J = jgb.Matrix.from_coo(rows, cols, vals, n, n)
    desc = tgb.DEFAULT.replace(mxv_mode=getattr(tgb.Direction, mode))
    jdesc = jgb.Descriptor(mxv_mode=getattr(jgb.Direction, mode))
    deg = np.diff(A.host_csr()[0])
    for s in (int(np.flatnonzero(deg)[0]), int(np.argmax(deg))):
        taken = _recording(monkeypatch)
        got = tgb.algorithms.sssp(A, s, desc).to_numpy()
        assert taken and all(taken)
        monkeypatch.setattr(mp, "takes_bound", lambda *a: False)
        off = tgb.algorithms.sssp(A, s, desc).to_numpy()
        monkeypatch.undo()
        np.testing.assert_array_equal(got, off)
        want = np.asarray(jax_sssp(J, s, desc=jdesc).to_numpy())
        np.testing.assert_array_equal(got, want)
        assert int((got < MAXF).sum()) > 1


def test_cc_never_takes_the_masked_entry(monkeypatch):
    """CC's MinimumSelectSecond pulls over K4 pass no bound."""
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(10, 16, seed=42, device="cpu")
    taken = _recording(monkeypatch)
    labels = tgb.algorithms.cc(A).to_numpy()
    assert taken and not any(taken)
    np.testing.assert_array_equal(labels, tgb.algorithms.cc_cpu(A))
