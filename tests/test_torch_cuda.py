"""Tests of graphblast_tpu_torch that need an NVIDIA card (marker `cuda`).

They skip where torch.cuda.is_available() is False. On a machine with a
card:  python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch.ops.kernels import bitmap_pull as bp
from graphblast_tpu_torch.ops.kernels import monoid_pull as mp
from graphblast_tpu_torch.ops.kernels import value_pull as vp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n_out,n_in,m", [(500, 700, 3000), (20000, 9000, 1),
                                          (1, 33, 0), (3000, 100000, 200000)])
def test_kernel_matches_plain_on_the_card(cuda, n_out, n_in, m):
    rng = np.random.default_rng(n_out + m)
    rows = np.sort(rng.integers(0, n_out, m))
    cols = rng.integers(0, n_in, m)
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    plan = bp.build_plan_bitmap(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(cols.astype(np.int32)).to(cuda), n_out, n_in)
    f = torch.from_numpy((rng.random(n_in) < 0.3).astype(np.float32))
    words = bp.pack_bitmap(f.to(cuda))
    launches = bp.spmv_bitmap_pull.launches
    y = bp.spmv_bitmap_pull(plan, words)
    torch.cuda.synchronize()
    assert bp.spmv_bitmap_pull.launches == launches + 1
    assert torch.equal(y, bp.spmv_bitmap_pull_plain(plan, words))
    np.testing.assert_array_equal(words.cpu().numpy(),
                                  bp.pack_bitmap(f).numpy())


def test_bfs_on_the_card_matches_golden(cuda):
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    deg = np.diff(A.host_csr()[0])
    s = int(np.argmax(deg))
    desc = tgb.BFS_TUNED.replace(mxv_mode=tgb.Direction.PULLONLY)
    launches = bp.spmv_bitmap_pull.launches
    got = tgb.algorithms.bfs(A, s, desc).to_numpy()
    np.testing.assert_array_equal(got, tgb.algorithms.bfs_cpu(A, s))
    assert bp.spmv_bitmap_pull.launches - launches == int(got.max())


@pytest.mark.parametrize("n_out,n_in,m,hub", [
    (500, 700, 3000, 0), (20000, 9000, 1, 0), (1, 33, 0, 0),
    (3000, 100000, 200000, 0), (300, 5000, 9000, 6000)])
@pytest.mark.parametrize("unit", [False, True])
def test_value_pull_matches_plain_on_the_card(cuda, n_out, n_in, m, hub,
                                              unit):
    """The value-pull kernel vs its plain version within 1e-5 * max|y| (the
    bar of tests/test_pallas.py; the kernel sums in float32, the plain
    version in float64), and bitwise equal to a second launch. `hub` edges
    go to one row; the edge arrays carry padding past ptr[n_out]."""
    rng = np.random.default_rng(n_out + m + unit)
    rows = np.sort(np.r_[rng.integers(0, n_out, m), np.full(hub, n_out // 2)])
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    pad = np.zeros(128, np.int64)
    val = None if unit else torch.from_numpy(
        rng.standard_normal(len(rows) + 128).astype(np.float32)).to(cuda)
    plan = vp.build_plan(torch.from_numpy(ptr.astype(np.int32)).to(cuda),
                         torch.from_numpy(np.r_[cols, pad].astype(np.int32))
                         .to(cuda), val, n_out, n_in)
    x = torch.from_numpy(rng.standard_normal(n_in).astype(np.float32)).to(cuda)
    launches = vp.spmv_value_pull.launches
    y = vp.spmv_value_pull(plan, x)
    y2 = vp.spmv_value_pull(plan, x)
    torch.cuda.synchronize()
    assert vp.spmv_value_pull.launches == launches + 2
    want = vp.spmv_value_pull_plain(plan, x)
    assert y.shape == (n_out,) and y.dtype == torch.float32
    assert float((y - want).abs().max()) <= 1e-5 * max(
        float(want.abs().max()), 1e-30)
    assert torch.equal(y, y2)


def test_value_pull_refuses_what_the_kernel_does_not_take(cuda):
    plan = vp.build_plan(torch.tensor([0, 1], dtype=torch.int32, device=cuda),
                         torch.tensor([0], dtype=torch.int32, device=cuda),
                         None, 1, 4)
    with pytest.raises(ValueError):
        vp.spmv_value_pull(plan, torch.zeros(8, device=cuda)[::2])
    with pytest.raises(TypeError):
        vp.spmv_value_pull(plan, torch.zeros(4, device=cuda,
                                             dtype=torch.float64))
    with pytest.raises(ValueError):
        vp.spmv_value_pull(plan, torch.zeros(4))


def test_pr_on_the_card_matches_golden(cuda):
    """PageRank on the card vs the port's NumPy golden at its fixed point
    (rtol 1e-3 / atol 1e-6, as tests/test_algorithms.py), one value-pull
    launch per iteration."""
    from graphblast_tpu_torch.algorithms.pr import _pr_fused, prepare_pr_plan
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    launches = vp.spmv_value_pull.launches
    got = tgb.algorithms.pr(A, eps=1e-10).to_numpy()
    launches = vp.spmv_value_pull.launches - launches
    want = tgb.algorithms.pr_cpu(A, 0.85, eps=1e-14, max_niter=300)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    _, iters, err = _pr_fused(A, prepare_pr_plan(A), alpha=0.85, eps=1e-10,
                              max_niter=tgb.DEFAULT.max_niter)
    assert launches == iters > 0 and err <= 1e-10


MONOID_SEMIRINGS = ["MinimumPlus", "MinimumMultiplies", "MinimumSelectSecond",
                    "MaximumMultiplies"]


@pytest.mark.parametrize("n_out,n_in,m,hub", [
    (300, 300, 2500, 0), (20000, 9000, 1, 0), (1, 33, 0, 0),
    (3000, 100000, 200000, 0), (300, 5000, 9000, 6000)])
@pytest.mark.parametrize("name", MONOID_SEMIRINGS)
@pytest.mark.parametrize("unit", [False, True])
def test_monoid_pull_matches_plain_on_the_card(cuda, n_out, n_in, m, hub,
                                               name, unit):
    """K4 vs its plain version, tolerance 0 (min and max pick one product,
    each product one float32 operation, on both), and bitwise equal to a
    second launch. x has 40% FLT_MAX entries, values may be negative and
    1e38 large so that products overflow and saturate; `hub` edges go to
    one row; the edge arrays carry padding past ptr[n_out]."""
    rng = np.random.default_rng(n_out + m + unit)
    rows = np.sort(np.r_[rng.integers(0, n_out, m), np.full(hub, n_out // 2)])
    cols = rng.integers(0, n_in, len(rows))
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    pad = np.zeros(128, np.int64)
    vals = rng.uniform(-2.0, 2.0, len(rows) + 128).astype(np.float32)
    vals[::97] = 1e38
    val = None if unit else torch.from_numpy(vals).to(cuda)
    plan = mp.build_plan_monoid(
        torch.from_numpy(ptr.astype(np.int32)).to(cuda),
        torch.from_numpy(np.r_[cols, pad].astype(np.int32)).to(cuda), val,
        n_out, n_in)
    maxf = np.float32(np.finfo(np.float32).max)
    x = np.where(rng.random(n_in) < 0.4, maxf,
                 rng.uniform(-5.0, 5.0, n_in)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    sr = getattr(tgb.semiring, f"{name}Semiring")
    launches = mp.spmv_monoid.launches
    y = mp.spmv_monoid(plan, x, sr)
    y2 = mp.spmv_monoid(plan, x, sr)
    torch.cuda.synchronize()
    assert mp.spmv_monoid.launches == launches + 2
    assert y.shape == (n_out,) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, mp.spmv_monoid_plain(plan, x, sr))
    assert torch.equal(y, y2)
    cpu = mp.build_plan_monoid(plan.ptr.cpu(), plan.ind.cpu(),
                               None if unit else plan.val.cpu(), n_out, n_in)
    assert torch.equal(y.cpu(), mp.spmv_monoid(cpu, x.cpu(), sr))


def test_sssp_and_cc_on_the_card_match_golden(cuda):
    """SSSP from the hub and CC at RMAT scale 12 on the card equal the
    port's goldens, with one K4 launch per iteration and no other kernel."""
    from graphblast_tpu_torch.algorithms.cc import _cc_fused
    from graphblast_tpu_torch.algorithms.sssp import _sssp_fused
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=42, device=cuda)
    s = int(np.argmax(np.diff(A.host_csr()[0])))
    desc = tgb.DEFAULT.replace(mxv_mode=tgb.Direction.PULLONLY)
    others = bp.spmv_bitmap_pull.launches + vp.spmv_value_pull.launches
    launches = mp.spmv_monoid.launches
    dist = tgb.algorithms.sssp(A, s, desc).to_numpy()
    k_sssp = mp.spmv_monoid.launches - launches
    labels = tgb.algorithms.cc(A).to_numpy()
    k_cc = mp.spmv_monoid.launches - launches - k_sssp
    assert bp.spmv_bitmap_pull.launches + vp.spmv_value_pull.launches == others
    np.testing.assert_array_equal(dist, tgb.algorithms.sssp_cpu(A, s))
    np.testing.assert_array_equal(labels, tgb.algorithms.cc_cpu(A))
    assert tgb.algorithms.verify_cc(A, labels)
    _, it = _sssp_fused(A, s, mp.plan_for_monoid(A, transpose=True),
                        switchpoint=0.01, mode=tgb.Direction.PULLONLY,
                        max_niter=1000)
    _, it_cc = _cc_fused(A, mp.plan_for_monoid(A, ones=True), max_niter=1000)
    assert k_sssp == it > 0 and k_cc == it_cc > 0
