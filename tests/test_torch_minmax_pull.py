"""S, the min/max row fold of the plan-less pull, on the CPU
(graphblast_tpu_torch ops/kernels/minmax_pull.py).

The CUDA kernel reads rows through the orientation's RowSchedule, as the
value pull, K4 and K1 do (csrc/row_schedule.cuh). Here its folds are
replayed in NumPy from the schedule alone: each work item's products
folded from ⊕'s true neutral (INT_MIN / INT_MAX, -inf / +inf), a long row's
chunk results folded in chunk order from it, and the semiring's identity
written only for empty rows; min and max propagate NaN and int32 products
wrap. min and max do not depend on order, so the replay must equal the
plain version exactly (tolerance 0; NaN where it is NaN, zeros up to their
sign) on every schedule case of tests/test_torch_value_sched.py, and both
must equal the JAX package's spmv_pull (its CPU path: the gather, then the
Hillis–Steele scan of segops.segmented_scan) for the five semirings with a
min/max ⊕, on int32 and float32 frontiers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops.spmv import spmv_pull as jspmv_pull
from graphblast_tpu_torch.ops.kernels import minmax_pull as mm
from graphblast_tpu_torch.ops.kernels import row_schedule as rs
from graphblast_tpu_torch.ops.spmv import spmv_pull
from test_torch_sched_kernels import _replay_fold
from test_torch_value_sched import CASES, T, _case

SEMIRINGS = list(mm.SEMIRING_MAP)
DTYPES = [np.int32, np.float32]
I32 = np.iinfo(np.int32)
# ⊕'s true neutral, where every fold of the kernel starts
NEUTRAL = {("min", np.int32): I32.max, ("max", np.int32): I32.min,
           ("min", np.float32): np.inf, ("max", np.float32): -np.inf}
# the schedule cases, and one row longer than 3·T alone
ALL_CASES = list(CASES) + ["one_long_row"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sr(name, pkg=tgb):
    return getattr(pkg.semiring, f"{name}Semiring")


def _graph(name, seed=3):
    """(n_out, n_in, ptr, cols) of a schedule case."""
    if name == "one_long_row":
        rng = np.random.default_rng(seed)
        m = 3 * T + 1
        return 1, 5000, np.array([0, m]), rng.integers(0, 5000, m)
    n_out, n_in, ptr, cols, _, _ = _case(name, seed)
    return n_out, n_in, ptr, cols


def _inputs(dtype, n_in, m, seed):
    """x and val of every sign. int32: a third small, the rest anywhere in
    int32, so that sums and products wrap; float32: ±inf in x, NaN in x
    and val, zeros in val (0·inf is NaN)."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(I32.min, I32.max, n_in, dtype=np.int64)
        small = rng.random(n_in) < 0.3
        x[small] = rng.integers(-5, 6, int(small.sum()))
        val = rng.integers(I32.min, I32.max, m, dtype=np.int64)
        val[::3] = rng.integers(-3, 4, len(val[::3]))
        return x.astype(np.int32), val.astype(np.int32)
    x = rng.uniform(-5.0, 5.0, n_in).astype(np.float32)
    x[rng.random(n_in) < 0.1] = np.inf
    x[rng.random(n_in) < 0.1] = -np.inf
    x[rng.random(n_in) < 0.03] = np.nan
    val = rng.uniform(-2.0, 2.0, m).astype(np.float32)
    val[::17] = 0.0
    val[::29] = np.nan
    return x, val


def _products(mul, cols, val, x):
    """Each edge's product in x's dtype, as the kernel forms it: int32
    wraps, float32 rounds once, not-equal-to gives 1 or 0."""
    xv = x[np.clip(cols, 0, len(x) - 1)]
    with np.errstate(all="ignore"):
        if mul == "second":
            return xv
        if mul == "plus":
            return (val + xv).astype(x.dtype)
        if mul == "mul":
            return (val * xv).astype(x.dtype)
        return (val != xv).astype(x.dtype)


def _minmax_replay(name, sched, ptr, cols, val, x, n_out, start=None):
    """S's folds from the schedule alone: each work item from ⊕'s neutral
    (or `start`), the chunks of a long row in order; then the identity on
    the rows with no edges."""
    add, mul = mm.SEMIRING_MAP[name]
    neutral = NEUTRAL[add, x.dtype.type] if start is None else start
    terms = _products(mul, cols[:ptr[-1]], val[:ptr[-1]], x)
    y = _replay_fold(sched, ptr, terms, x.dtype.type(neutral),
                     np.minimum if add == "min" else np.maximum, n_out)
    y[np.diff(ptr) == 0] = _sr(name).identity(_t(x).dtype).item()
    return y


def _plain(name, ptr, cols, val, x, n_out):
    return mm.spmv_minmax_pull_plain(
        _t(ptr.astype(np.int32)), _t(cols.astype(np.int32)), _t(val), _t(x),
        _sr(name), n_out).numpy()


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", ALL_CASES)
def test_minmax_replay_matches_plain(case, semiring, dtype):
    """S's folds replayed from the row schedule equal
    spmv_minmax_pull_plain exactly, on every schedule case; empty rows hold
    the semiring's identity."""
    n_out, n_in, ptr, cols = _graph(case)
    x, val = _inputs(dtype, n_in, len(cols), len(case) + len(semiring))
    sched = rs.build_schedule(_t(ptr.astype(np.int32)))
    got = _minmax_replay(semiring, sched, ptr, cols, val, x, n_out)
    want = _plain(semiring, ptr, cols, val, x, n_out)
    assert got.dtype == want.dtype == dtype and got.shape == (n_out,)
    np.testing.assert_array_equal(got, want)
    ident = _sr(semiring).identity(_t(x).dtype).item()
    assert (want[np.diff(ptr) == 0] == ident).all()


JAX_CASES = ["hub_over_3T", "every_length", "mostly_empty", "one_long_row"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", JAX_CASES)
def test_minmax_pull_matches_jax_spmv_pull(case, semiring, dtype):
    """The plain version, the schedule replay and the port's spmv_pull
    (which routes these semirings to S) vs the JAX spmv_pull on the same
    arrays, tolerance 0: int32 products that wrap, ±inf and NaN."""
    n_out, n_in, ptr, cols = _graph(case)
    x, val = _inputs(dtype, n_in, len(cols), 7 + len(semiring))
    ptr32, cols32 = ptr.astype(np.int32), cols.astype(np.int32)
    want = np.asarray(jspmv_pull(jnp.asarray(ptr32), jnp.asarray(cols32),
                                 jnp.asarray(val), jnp.asarray(x),
                                 _sr(semiring, jgb), n_out))
    sched = rs.build_schedule(_t(ptr32))
    np.testing.assert_array_equal(
        _minmax_replay(semiring, sched, ptr, cols, val, x, n_out), want)
    np.testing.assert_array_equal(
        _plain(semiring, ptr, cols, val, x, n_out), want)
    got = spmv_pull(_t(ptr32), _t(cols32), _t(val), _t(x), _sr(semiring),
                    n_out, sched=sched)
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _negative_rows():
    """Rows whose products are all negative, of every bin's length (1, 5,
    40 and a long row over T), an empty row, and a row with one positive
    product among negative ones."""
    lengths = [1, 5, 40, 0, 3, T + 9]
    ptr = np.r_[0, np.cumsum(lengths)]
    m = int(ptr[-1])
    cols = np.arange(m) % 50
    x = -np.arange(1, 51).astype(np.int32)        # every x negative
    val = np.ones(m, np.int32)
    val[ptr[4] + 1] = -1                          # row 4: one product > 0
    return ptr, cols, val, x


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
def test_all_negative_rows_keep_their_maximum(dtype):
    """The MaximumMonoid identity trap: MaximumMultiplies' identity is 0,
    yet a row whose products are all negative gives its largest product,
    as the JAX scan (which folds only the row's own edges) does; only the
    empty row gives 0. A fold started at the identity would give 0."""
    ptr, cols, val, x = _negative_rows()
    val, x = val.astype(dtype), x.astype(dtype)
    n_out = len(ptr) - 1
    name = "MaximumMultiplies"
    # x[c] = -(c + 1); row 4's second product is (-1)·(-48)
    want = np.array([-1, -2, -7, 0, 48, -1], dtype)
    np.testing.assert_array_equal(_plain(name, ptr, cols, val, x, n_out),
                                  want)
    sched = rs.build_schedule(_t(ptr.astype(np.int32)))
    assert sched.bin_rows[0] == 1                 # the long row is a cluster
    np.testing.assert_array_equal(
        _minmax_replay(name, sched, ptr, cols, val, x, n_out), want)
    np.testing.assert_array_equal(np.asarray(jspmv_pull(
        jnp.asarray(ptr.astype(np.int32)), jnp.asarray(cols.astype(np.int32)),
        jnp.asarray(val), jnp.asarray(x), _sr(name, jgb), n_out)), want)
    # a fold that started at the identity, as K4's does, would be wrong
    from_identity = _minmax_replay(name, sched, ptr, cols, val, x, n_out,
                                   start=0)
    assert (from_identity[[0, 1, 2, 5]] == 0).all()


def test_float_edges_inf_nan_and_signed_zero():
    """No clamp: inf stays inf and inf + (-inf) is NaN; NaN propagates
    through min and max (fminf / fmaxf would drop it); NotEqualTo gives 1
    on NaN. Hand-made rows, against JAX."""
    inf, nan = np.inf, np.nan
    ptr = np.array([0, 2, 4, 6, 8, 9])
    cols = np.array([0, 1, 2, 3, 4, 1, 5, 0, 2])
    x = np.array([inf, -inf, 1.0, nan, 3.0, -0.0], np.float32)
    val = np.array([1, 1, 1, 1, 1, 2, 0, 1, 1], np.float32)
    val[4] = -inf
    for name in SEMIRINGS:
        want = np.asarray(jspmv_pull(
            jnp.asarray(ptr.astype(np.int32)),
            jnp.asarray(cols.astype(np.int32)), jnp.asarray(val),
            jnp.asarray(x), _sr(name, jgb), 5))
        got = _plain(name, ptr, cols, val, x, 5)
        np.testing.assert_array_equal(got, want, err_msg=name)
        sched = rs.build_schedule(_t(ptr.astype(np.int32)))
        np.testing.assert_array_equal(
            _minmax_replay(name, sched, ptr, cols, val, x, 5), want,
            err_msg=name)
    # MinimumPlus: row 0 is min(1 + inf, 1 + (-inf)) = -inf, row 1 meets
    # a NaN, row 2 holds -inf + 3 and 2 + (-inf): no clamp to ±FLT_MAX
    y = _plain("MinimumPlus", ptr, cols, val, x, 5)
    assert y[0] == -np.inf and np.isnan(y[1]) and y[2] == -np.inf


def test_int32_products_wrap_as_torch_does():
    """int32 products and sums wrap modulo 2^32 on both sides."""
    ptr = np.array([0, 2, 3])
    cols = np.array([0, 1, 1])
    x = np.array([1 << 30, I32.max], np.int32)
    val = np.array([4, 2, 1], np.int32)
    y = _plain("MaximumMultiplies", ptr, cols, val, x, 2)
    # 2^30·4 wraps to 0 and INT_MAX·2 to -2; row 1 is INT_MAX
    np.testing.assert_array_equal(y, [0, I32.max])
    # 2 + INT_MAX wraps to INT_MIN + 1, and 1 + INT_MAX to INT_MIN
    y = _plain("MinimumPlus", ptr, cols, val, x, 2)
    np.testing.assert_array_equal(y, [I32.min + 1, I32.min])


def test_minmax_pull_routes_and_refuses():
    """spmv_pull sends exactly the five semirings on int32 and float32 to
    S (every other monoid, and other dtypes, keep segops); the wrapper
    refuses what the kernel does not take."""
    assert all(mm.minmax_supported(_sr(n), d) for n in SEMIRINGS
               for d in (torch.int32, torch.float32))
    assert not mm.minmax_supported(_sr("MinimumPlus"), torch.float64)
    assert not any(mm.minmax_supported(s, torch.float32)
                   for s in tgb.ALL_SEMIRINGS if s.name not in SEMIRINGS)
    assert {s.add.name for s in tgb.ALL_SEMIRINGS if s.name in SEMIRINGS} \
        == {"MinimumMonoid", "MaximumMonoid"}
    ptr = torch.tensor([0, 2, 2], dtype=torch.int32)
    ind = torch.tensor([0, 1], dtype=torch.int32)
    x = torch.tensor([3, -4], dtype=torch.int32)
    sr = tgb.MaximumMultipliesSemiring
    with pytest.raises(ValueError, match="reads edge values"):
        mm.spmv_minmax_pull(ptr, ind, None, x, sr, 2)
    with pytest.raises(ValueError, match="no min/max"):
        mm.spmv_minmax_pull(ptr, ind, x, x.double(), sr, 2)
    with pytest.raises(TypeError):
        mm.spmv_minmax_pull(ptr.long(), ind, x, x, sr, 2)
    with pytest.raises(ValueError, match="entries"):
        mm.spmv_minmax_pull(ptr, ind, x, x, sr, 3)
    with pytest.raises(ValueError, match="empty x"):
        mm.spmv_minmax_pull(ptr, ind, x, x[:0], sr, 2)
    # select-second reads no values; the CPU needs no schedule
    y = mm.spmv_minmax_pull(ptr, ind, None, x, tgb.MinimumSelectSecondSemiring,
                            2)
    np.testing.assert_array_equal(y.numpy(), [-4, I32.max])
    launches = mm.spmv_minmax_pull.launches
    np.testing.assert_array_equal(
        mm.spmv_minmax_pull(ptr, ind, x, x, sr, 2).numpy(), [16, 0])
    assert mm.spmv_minmax_pull.launches == launches   # the CPU runs plain
