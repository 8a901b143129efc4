"""The port's monoid pull (K4) against the JAX package (graphblast_tpu_torch).

The monoid pull runs here as its plain PyTorch version (CPU tensors). The
same inputs, made with NumPy from a seed, go through the JAX `spmv_monoid`
in interpret mode and through a float32 NumPy golden. Tolerances: the port
equals the float32 golden exactly (min and max pick one of the products,
and each product is one float32 operation); it is held to the JAX kernel
at rel 1e-5 with matmul="highest", the bar of tests/test_pallas.py, whose
one-hot select can round a selected value. The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp

MAXF = np.float32(np.finfo(np.float32).max)
SEMIRINGS = ["MinimumPlus", "MinimumMultiplies", "MinimumSelectSecond",
             "MaximumMultiplies"]


def _sr(name, pkg=tgb):
    return getattr(pkg.semiring, f"{name}Semiring")


def _golden(name, ptr, cols, vals, x, n_out):
    """Float32 NumPy golden: ⊗ in float32, clamp to ±FLT_MAX, then
    np.minimum.at / np.maximum.at into the identity."""
    add, mul = mp.SEMIRING_MAP[name]
    rows = np.repeat(np.arange(n_out), np.diff(ptr))
    xv = x[cols]
    with np.errstate(over="ignore"):
        p = {"plus": vals + xv, "mul": vals * xv, "second": xv}[mul]
    p = np.clip(p, -MAXF, MAXF).astype(np.float32)
    ident = np.float32(float(_sr(name).identity(torch.float32)))
    y = np.full(n_out, ident, np.float32)
    (np.minimum if add == "min" else np.maximum).at(y, rows, p)
    return y


def _plan(ptr, cols, vals, n_out, n_in):
    return mp.build_plan_monoid(
        torch.from_numpy(np.asarray(ptr).astype(np.int32)),
        torch.from_numpy(np.asarray(cols).astype(np.int32)),
        None if vals is None else torch.from_numpy(vals), n_out, n_in)


def _pallas_case():
    """The input of tests/test_pallas.py::test_monoid_pull_kernel_goldens'
    smoke size: n = 300, m = 2500 (deduplicated), seed 0, weights in
    [0.5, 3.5), x with 40% FLT_MAX entries and the rest in [0, 5)."""
    rng = np.random.default_rng(0)
    n_out, n_in, m = 300, 300, 2500
    rows = rng.integers(0, n_out, m)
    cols = rng.integers(0, n_in, m)
    _, keep = np.unique(rows.astype(np.int64) * n_in + cols,
                        return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = (rng.random(len(rows)) * 3 + 0.5).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    x = np.where(rng.random(n_in) < 0.4, MAXF,
                 (rng.random(n_in) * 5).astype(np.float32)).astype(np.float32)
    return ptr, cols, vals, x, n_out, n_in


@pytest.mark.parametrize("name", SEMIRINGS)
def test_monoid_pull_matches_pallas_and_golden(name):
    from graphblast_tpu.ops.pallas.monopull import (build_plan_monoid,
                                                    spmv_monoid)

    ptr, cols, vals, x, n_out, n_in = _pallas_case()
    want = np.asarray(spmv_monoid(build_plan_monoid(ptr, cols, vals, n_out,
                                                    n_in),
                                  jnp.asarray(x), _sr(name, jgb),
                                  matmul="highest"))
    got = mp.spmv_monoid(_plan(ptr, cols, vals, n_out, n_in),
                         torch.from_numpy(x), _sr(name))
    assert got.dtype == torch.float32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(),
                                  _golden(name, ptr, cols, vals, x, n_out))
    rel = np.abs(got.numpy().astype(np.float64) - want) / (np.abs(want) + 1)
    assert rel.max() <= 1e-5, rel.max()


@pytest.mark.parametrize("name", SEMIRINGS)
def test_empty_rows_and_empty_plan_keep_the_identity(name):
    """Row 1 has no edges and keeps the identity (FLT_MAX for the min
    semirings, 0 for MaximumMultiplies); an empty plan gives all identity.
    The values of tests/test_pallas.py::test_monoid_pull_empty_and_identity_
    rows, whose MinimumPlus result is [11, FLT_MAX, 23]."""
    ident = np.float32(float(_sr(name).identity(torch.float32)))
    ptr = np.array([0, 2, 2, 3])
    cols = np.array([0, 2, 1])
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    x = np.array([10.0, 20.0, 30.0], np.float32)
    got = mp.spmv_monoid(_plan(ptr, cols, vals, 3, 3), torch.from_numpy(x),
                         _sr(name)).numpy()
    assert got[1] == ident
    np.testing.assert_array_equal(got, _golden(name, ptr, cols, vals, x, 3))
    if name == "MinimumPlus":
        np.testing.assert_array_equal(got, [11.0, MAXF, 23.0])
    empty = _plan(np.zeros(4), np.zeros(0), None, 3, 3)
    np.testing.assert_array_equal(
        mp.spmv_monoid(empty, torch.from_numpy(x), _sr(name)).numpy(),
        np.full(3, ident))


def test_products_saturate_at_flt_max():
    """FLT_MAX + 1e38 and 3 * FLT_MAX overflow to inf in float32; the pull
    gives FLT_MAX (the unreached sentinel), as the JAX kernel's clamp
    does. A product of -inf clamps to -FLT_MAX, which min keeps."""
    ptr = np.array([0, 1, 2, 3, 4])
    cols = np.array([0, 1, 0, 1])
    vals = np.array([1e38, 3.0, 1e38, -3.0], np.float32)
    x = np.array([MAXF, MAXF], np.float32)
    plan = _plan(ptr, cols, vals, 4, 2)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        mp.spmv_monoid(plan, xt, tgb.MinimumPlusSemiring).numpy(),
        [MAXF, MAXF, MAXF, MAXF])
    np.testing.assert_array_equal(
        mp.spmv_monoid(plan, xt, tgb.MinimumMultipliesSemiring).numpy(),
        [MAXF, MAXF, MAXF, -MAXF])


def test_maximum_multiplies_never_goes_below_zero():
    """MaximumMonoid's identity is 0 (the reference quirk), so a row whose
    products are all negative gives 0, in the port and in JAX."""
    from graphblast_tpu.ops.pallas.monopull import (build_plan_monoid,
                                                    spmv_monoid)

    ptr = np.array([0, 2, 3, 3])
    cols = np.array([0, 1, 1])
    vals = np.array([-1.0, 2.0, 0.5], np.float32)
    x = np.array([4.0, -3.0], np.float32)
    want = np.asarray(spmv_monoid(build_plan_monoid(ptr, cols, vals, 3, 2),
                                  jnp.asarray(x),
                                  jgb.semiring.MaximumMultipliesSemiring,
                                  matmul="highest"))
    got = mp.spmv_monoid(_plan(ptr, cols, vals, 3, 2), torch.from_numpy(x),
                         tgb.MaximumMultipliesSemiring).numpy()
    np.testing.assert_array_equal(got, [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(got, want)


def test_select_second_ignores_values():
    """Select-second reads x only: any values, or none, give the same y."""
    rng = np.random.default_rng(4)
    ptr, cols, _, x, n_out, n_in = _pallas_case()
    sr = tgb.MinimumSelectSecondSemiring
    xt = torch.from_numpy(x)
    want = mp.spmv_monoid(_plan(ptr, cols, None, n_out, n_in), xt, sr)
    for vals in (np.full(len(cols), np.nan, np.float32),
                 rng.uniform(-3e38, 3e38, len(cols)).astype(np.float32)):
        got = mp.spmv_monoid(_plan(ptr, cols, vals, n_out, n_in), xt, sr)
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_unit_plan_multiplies_by_one(name):
    """A unit-valued plan (val=None) has the value 1 on every edge, as
    the JAX build_plan_monoid fills it."""
    ptr, cols, _, x, n_out, n_in = _pallas_case()
    got = mp.spmv_monoid(_plan(ptr, cols, None, n_out, n_in),
                         torch.from_numpy(x), _sr(name))
    ones = np.ones(len(cols), np.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  _golden(name, ptr, cols, ones, x, n_out))


def test_monoid_pull_reads_only_the_rows_edges():
    """Padding past ptr[n_out] (as the Matrix's TILE padding) is never
    read."""
    ptr = np.array([0, 2, 2, 3])
    cols = np.array([1, 0, 2, 0, 0, 0])               # 3 padding entries
    vals = np.array([2.0, 3.0, 1.0, -1e9, -1e9, -1e9], np.float32)
    x = np.array([1.0, 10.0, 100.0], np.float32)
    y = mp.spmv_monoid(_plan(ptr, cols, vals, 3, 3), torch.from_numpy(x),
                       tgb.MinimumPlusSemiring)
    np.testing.assert_array_equal(y.numpy(), [4.0, MAXF, 101.0])


def test_plan_for_monoid_orientation_and_cache():
    """plan_for_monoid reads the CSR for mxv and the CSC for vxm, caches
    under csr/monoid and csc/monoid (+ /ones), and gives None for a missing
    orientation (the semantics of monopull.py plan_for_monoid)."""
    from graphblast_tpu_torch.types import SparseFormat

    rows, cols = np.array([0, 0, 1, 3]), np.array([1, 2, 2, 0])
    vals = np.array([2.0, 3.0, 5.0, 7.0])
    A = tgb.Matrix.from_coo(rows, cols, vals, 4, 5, device="cpu")
    x = torch.tensor([1.0, 10.0, 100.0, 1000.0])       # over rows
    pt = mp.plan_for_monoid(A, transpose=True)
    assert isinstance(pt, mp.MonoidPlan) and (pt.n_out, pt.n_in) == (5, 4)
    np.testing.assert_array_equal(
        mp.spmv_monoid(pt, x, tgb.MinimumPlusSemiring).numpy(),
        [1007.0, 3.0, 4.0, MAXF, MAXF])
    assert mp.plan_for_monoid(A, transpose=True) is pt
    ones = mp.plan_for_monoid(A, ones=True)
    assert ones.val is None and (ones.n_out, ones.n_in) == (4, 5)
    np.testing.assert_array_equal(
        mp.spmv_monoid(ones, torch.arange(5.0),
                       tgb.MinimumSelectSecondSemiring).numpy(),
        [1.0, 2.0, MAXF, 0.0])
    pc = mp.plan_for_monoid(A)
    assert pc.val is not None and pc is not ones
    # and one row schedule for each orientation, which the plans share
    assert set(A._plans) == {"csc/monoid", "csr/monoid/ones", "csr/monoid",
                             "csc/schedule", "csr/schedule"}
    assert pc.sched is ones.sched is A._plans["csr/schedule"]
    assert pt.sched is A._plans["csc/schedule"]
    C = tgb.Matrix.from_coo(rows, cols, vals, 4, 5, fmt=SparseFormat.CSRONLY,
                            device="cpu")
    assert mp.plan_for_monoid(C, transpose=True) is None
    assert mp.plan_for_monoid(C) is not None


def test_monoid_pull_checks_its_inputs():
    ptr = np.array([0, 2, 3])
    cols = np.array([0, 40, 7])
    vals = np.ones(3, np.float32)
    plan = _plan(ptr, cols, vals, 2, 41)
    sr = tgb.MinimumPlusSemiring
    with pytest.raises(ValueError):          # a semiring the kernel lacks
        mp.spmv_monoid(plan, torch.zeros(41), tgb.PlusMultipliesSemiring)
    assert not mp.monoid_supported(tgb.PlusMultipliesSemiring)
    with pytest.raises(ValueError):          # x of the wrong length
        mp.spmv_monoid(plan, torch.zeros(40), sr)
    with pytest.raises(TypeError):           # x not float32
        mp.spmv_monoid(plan, torch.zeros(41, dtype=torch.float64), sr)
    with pytest.raises(ValueError):          # x not contiguous
        mp.spmv_monoid(plan, torch.zeros(82)[::2], sr)
    with pytest.raises(ValueError):   # a device with no kernel and no plain
        meta = mp.MonoidPlan(2, 41, plan.ptr.to("meta"), plan.ind.to("meta"),
                             plan.val.to("meta"))
        mp.spmv_monoid(meta, torch.zeros(41, device="meta"), sr)
    # build_plan_monoid shares value_pull.check_csr's bounds checks
    with pytest.raises(ValueError):          # column id beyond n_in
        _plan(ptr, cols, vals, 2, 40)
    with pytest.raises(ValueError):          # too few values
        _plan(ptr, cols, vals[:2], 2, 41)
    with pytest.raises(ValueError):          # ptr decreasing
        _plan(np.array([0, 3, 2]), cols, vals, 2, 41)
    with pytest.raises(ValueError):          # ptr past the end of ind
        _plan(np.array([0, 2, 4]), cols, vals, 2, 41)
    with pytest.raises(TypeError):           # int64 index arrays
        mp.build_plan_monoid(torch.from_numpy(ptr), torch.from_numpy(cols),
                             None, 2, 41)
    launches = mp.spmv_monoid.launches
    mp.spmv_monoid(plan, torch.zeros(41), sr)
    assert mp.spmv_monoid.launches == launches   # plain runs count 0
    empty = _plan(np.zeros(1), np.zeros(0), None, 0, 41)
    assert mp.spmv_monoid(empty, torch.zeros(41), sr).shape == (0,)
