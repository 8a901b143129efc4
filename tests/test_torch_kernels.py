"""The port's kernel modules against the JAX package (graphblast_tpu_torch).

K1, the bitmap pull, and the value pull that replaces K2 and K3 run here as
their plain PyTorch versions (CPU tensors; K4 is in test_torch_monoid.py);
the same inputs, made with NumPy from a seed, go through the Pallas kernels
in interpret mode and through a NumPy golden. Counts are integers, so those
comparisons are exact; value sums are held to 1e-5 of max|y|, the bar of
tests/test_pallas.py. The CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblast_tpu_torch.ops.kernels import bitmap_pull as bp
from graphblast_tpu_torch.ops.kernels import value_pull as vp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csr(rng, n_out, n_in, m):
    rows = np.sort(rng.integers(0, max(n_out, 1), m))
    cols = rng.integers(0, n_in, m)
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr), rows, cols


def _plan(ptr, cols, n_out, n_in):
    return bp.build_plan_bitmap(torch.from_numpy(ptr.astype(np.int32)),
                                torch.from_numpy(cols.astype(np.int32)),
                                n_out, n_in)


def _count(rows, cols, f, n_out):
    y = np.zeros(n_out, np.int64)
    np.add.at(y, rows, (f[cols] != 0).astype(np.int64))
    return y


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4097])
def test_pack_bitmap_matches_jax(n):
    from graphblast_tpu.ops.pallas.orpull import pack_bitmap

    rng = np.random.default_rng(n)
    x = (rng.random(n) < 0.5).astype(np.float32) * rng.integers(1, 5, n)
    x[31::32] = 2.0            # bit 31 set: words that wrap negative
    want = np.asarray(pack_bitmap(jnp.asarray(x)))
    got = bp.pack_bitmap(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if n >= 32:
        assert (got < 0).any()


@pytest.mark.parametrize("n_out,n_in,m", [(500, 700, 3000), (20000, 9000, 1)])
def test_bitmap_pull_matches_pallas(n_out, n_in, m):
    """The smoke shapes of tests/test_pallas.py::test_bitmap_bilinear."""
    from graphblast_tpu.ops.pallas.bilinear import (build_plan_bitmap,
                                                    spmv_bilinear_bitmap)
    from graphblast_tpu.ops.pallas.orpull import pack_bitmap

    rng = np.random.default_rng(7)
    ptr, rows, cols = _csr(rng, n_out, n_in, m)
    f = (rng.random(n_in) < 0.2).astype(np.float32)
    jplan = build_plan_bitmap(ptr, cols, n_out, n_in)
    want = np.asarray(spmv_bilinear_bitmap(jplan, pack_bitmap(jnp.asarray(f)),
                                           interpret=True, sweep="aligned"))
    got = bp.spmv_bitmap_pull(_plan(ptr, cols, n_out, n_in),
                              bp.pack_bitmap(torch.from_numpy(f)))
    assert got.dtype == torch.int32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _count(rows, cols, f, n_out))


def _hub_case(rng):
    # two hub rows holding most edges, empty rows between them
    n_out, n_in = 300, 5000
    rows = np.sort(np.r_[np.full(4000, 3), np.full(2500, 250),
                         rng.integers(0, n_out, 400)])
    return n_out, n_in, rows, rng.integers(0, n_in, len(rows))


def _random_case(n_out, n_in, m):
    def make(rng):
        _, rows, cols = _csr(rng, n_out, n_in, m)
        return n_out, n_in, rows, cols
    return make


@pytest.mark.parametrize("case", [
    _random_case(100, 50, 0),          # empty matrix
    _random_case(0, 64, 0),            # no output rows
    _random_case(700, 33, 5000),       # n_in not a multiple of 32
    _random_case(64, 100000, 20000),   # wide: many bitmap words
    _hub_case,
], ids=["empty", "no_rows", "n_in_33", "wide", "hubs"])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_bitmap_pull_matches_numpy(case, density):
    rng = np.random.default_rng(11)
    n_out, n_in, rows, cols = case(rng)
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    f = (rng.random(n_in) < density).astype(np.float32)
    got = bp.spmv_bitmap_pull(_plan(ptr, cols, n_out, n_in),
                              bp.pack_bitmap(torch.from_numpy(f)))
    np.testing.assert_array_equal(got.numpy(), _count(rows, cols, f, n_out))


def test_plan_reads_the_pull_orientation():
    """A directed matrix: the vxm plan is the CSC (in-edges), the mxv plan
    the CSR, and both are cached on the Matrix."""
    from graphblast_tpu_torch import Matrix

    rows, cols = np.array([0, 0, 1, 3]), np.array([1, 2, 2, 0])
    A = Matrix.from_coo(rows, cols, np.ones(4), 4, 5, device="cpu")
    f = np.array([1, 0, 0, 1], np.float32)          # frontier over rows
    pt = bp.plan_for_bitmap(A, transpose=True)
    assert (pt.n_out, pt.n_in) == (5, 4)
    y = bp.spmv_bitmap_pull(pt, bp.pack_bitmap(torch.from_numpy(f)))
    np.testing.assert_array_equal(y.numpy(), [1, 1, 1, 0, 0])
    assert bp.plan_for_bitmap(A, transpose=True) is pt
    pc = bp.plan_for_bitmap(A, transpose=False)
    x = np.array([0, 0, 1, 0, 0], np.float32)        # frontier over columns
    y = bp.spmv_bitmap_pull(pc, bp.pack_bitmap(torch.from_numpy(x)))
    np.testing.assert_array_equal(y.numpy(), [1, 1, 0, 0])


def test_bitmap_pull_checks_its_inputs():
    ptr = np.array([0, 2, 3], np.int64)
    cols = np.array([0, 40, 7])
    plan = _plan(ptr, cols, 2, 41)
    with pytest.raises(ValueError):
        bp.spmv_bitmap_pull(plan, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        bp.spmv_bitmap_pull(plan, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):   # a device with no kernel and no plain
        bp.spmv_bitmap_pull(
            bp.BitmapPlan(2, 41, plan.ptr.to("meta"), plan.ind.to("meta")),
            torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):   # column id beyond n_in
        _plan(ptr, cols, 2, 40)
    launches = bp.spmv_bitmap_pull.launches
    bp.spmv_bitmap_pull(plan, torch.zeros(2, dtype=torch.int32))
    assert bp.spmv_bitmap_pull.launches == launches   # plain runs count 0


# the smoke shapes of tests/test_pallas.py::test_spmv_bilinear and
# ::test_spmv_bilinear_dma (the cases not marked slow)
VALUE_CASES = [(500, 700, 3000), (9000, 5000, 1), (100, 100, 0),
               (20000, 9000, 1)]


def _value_case(n_out, n_in, m, seed=5):
    rng = np.random.default_rng(seed)
    ptr, rows, cols = _csr(rng, n_out, n_in, m)
    vals = rng.standard_normal(m).astype(np.float32)
    x = rng.standard_normal(n_in).astype(np.float32)
    return ptr, rows, cols, vals, x


def _value_plan(ptr, cols, vals, n_out, n_in):
    return vp.build_plan(torch.from_numpy(ptr.astype(np.int32)),
                         torch.from_numpy(cols.astype(np.int32)),
                         None if vals is None else torch.from_numpy(vals),
                         n_out, n_in)


def _golden(rows, cols, vals, x, n_out):
    y = np.zeros(n_out, np.float64)
    np.add.at(y, rows, vals.astype(np.float64) * x[cols].astype(np.float64))
    return y


@pytest.mark.parametrize("jax_kernel", ["pack1", "pack2", "dma"])
@pytest.mark.parametrize("n_out,n_in,m", VALUE_CASES)
def test_value_pull_matches_pallas(n_out, n_in, m, jax_kernel):
    """The plain value pull vs K2 (build_plan, pack 1 and 2) and K3
    (build_plan_f32dma) in interpret mode, within 1e-5 * max|y|."""
    from graphblast_tpu.ops.pallas.bilinear import (build_plan,
                                                    build_plan_f32dma,
                                                    spmv_bilinear,
                                                    spmv_bilinear_dma)

    ptr, rows, cols, vals, x = _value_case(n_out, n_in, m)
    if jax_kernel == "dma":
        want = spmv_bilinear_dma(
            build_plan_f32dma(ptr, cols, vals, n_out, n_in), jnp.asarray(x),
            interpret=True)
    else:
        want = spmv_bilinear(
            build_plan(ptr, cols, vals, n_out, n_in,
                       pack=int(jax_kernel[-1])), jnp.asarray(x),
            interpret=True)
    want = np.asarray(want)
    got = vp.spmv_value_pull(_value_plan(ptr, cols, vals, n_out, n_in),
                             torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n_out,)
    gold = _golden(rows, cols, vals, x, n_out)
    den = max(np.abs(gold).max(initial=0.0), 1e-9)
    assert np.abs(got.numpy() - want).max(initial=0.0) <= 1e-5 * den
    assert np.abs(got.numpy() - gold).max(initial=0.0) <= 1e-5 * den


@pytest.mark.parametrize("case", [
    _random_case(100, 50, 0),
    _random_case(0, 64, 0),
    _random_case(700, 33, 5000),
    _hub_case,
], ids=["empty", "no_rows", "n_in_33", "hubs"])
def test_unit_value_plan_counts_as_the_bitmap_pull(case):
    """A unit-valued plan on a 0/1 frontier gives K1's counts exactly."""
    rng = np.random.default_rng(13)
    n_out, n_in, rows, cols = case(rng)
    ptr = np.zeros(n_out + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    ptr = np.cumsum(ptr)
    f = (rng.random(n_in) < 0.3).astype(np.float32)
    unit = _value_plan(ptr, cols, None, n_out, n_in)
    assert unit.unit_vals
    got = vp.spmv_value_pull(unit, torch.from_numpy(f))
    want = bp.spmv_bitmap_pull(_plan(ptr, cols, n_out, n_in),
                               bp.pack_bitmap(torch.from_numpy(f)))
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.float32))


def test_value_pull_reads_only_the_rows_edges():
    """Padding past ptr[n_out] (as the Matrix's TILE padding) is never read,
    and rows with no edges give 0."""
    ptr = np.array([0, 2, 2, 3], np.int64)
    cols = np.array([1, 0, 2, 1, 1, 1])             # 3 padding entries
    vals = np.array([2.0, 3.0, -1.0, 1e9, 1e9, 1e9], np.float32)
    x = np.array([1.0, 10.0, 100.0], np.float32)
    y = vp.spmv_value_pull(_value_plan(ptr, cols, vals, 3, 3),
                           torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), [23.0, 0.0, -100.0])


def test_value_plan_for_orientation_and_cache():
    """plan_for reads the CSR for mxv and the CSC for vxm, caches under
    csr/csc (+ /ones), never caches a host_val plan, and gives None for a
    missing orientation (the semantics of bilinear.py plan_for)."""
    from graphblast_tpu_torch import Matrix
    from graphblast_tpu_torch.types import SparseFormat

    rows, cols = np.array([0, 0, 1, 3]), np.array([1, 2, 2, 0])
    vals = np.array([2.0, 3.0, 5.0, 7.0])
    A = Matrix.from_coo(rows, cols, vals, 4, 5, device="cpu")
    x = torch.tensor([1.0, 10.0, 100.0, 1000.0])       # over rows
    pt = vp.plan_for(A, transpose=True)
    assert (pt.n_out, pt.n_in, pt.unit_vals) == (5, 4, False)
    np.testing.assert_array_equal(vp.spmv_value_pull(pt, x).numpy(),
                                  [7000.0, 2.0, 53.0, 0.0, 0.0])
    assert vp.plan_for(A, transpose=True) is pt
    ones = vp.plan_for(A, transpose=True, ones=True)
    assert ones.unit_vals and ones is not pt
    assert set(A._plans) >= {"csc", "csc/ones"}
    np.testing.assert_array_equal(vp.spmv_value_pull(ones, x).numpy(),
                                  [1000.0, 1.0, 11.0, 0.0, 0.0])
    pc = vp.plan_for(A)
    assert (pc.n_out, pc.n_in) == (4, 5) and A._plans["csr"] is pc
    np.testing.assert_array_equal(
        vp.spmv_value_pull(pc, torch.arange(5, dtype=torch.float32)).numpy(),
        [8.0, 10.0, 0.0, 0.0])
    host = vp.plan_for(A, transpose=True, host_val=np.ones(4, np.float32))
    assert host.val.dtype == torch.float32 and host is not vp.plan_for(
        A, transpose=True, host_val=np.ones(4, np.float32))
    C = Matrix.from_coo(rows, cols, vals, 4, 5, fmt=SparseFormat.CSRONLY,
                        device="cpu")
    assert vp.plan_for(C, transpose=True) is None
    assert vp.plan_for(C) is not None


def test_value_pull_checks_its_inputs():
    ptr = np.array([0, 2, 3], np.int64)
    cols = np.array([0, 40, 7])
    vals = np.ones(3, np.float32)
    plan = _value_plan(ptr, cols, vals, 2, 41)
    with pytest.raises(ValueError):          # x of the wrong length
        vp.spmv_value_pull(plan, torch.zeros(40))
    with pytest.raises(TypeError):           # x not float32
        vp.spmv_value_pull(plan, torch.zeros(41, dtype=torch.float64))
    with pytest.raises(ValueError):          # x not contiguous
        vp.spmv_value_pull(plan, torch.zeros(82)[::2])
    with pytest.raises(ValueError):   # a device with no kernel and no plain
        meta = vp.ValuePlan(2, 41, plan.ptr.to("meta"), plan.ind.to("meta"),
                            plan.val.to("meta"))
        vp.spmv_value_pull(meta, torch.zeros(41, device="meta"))
    with pytest.raises(ValueError):          # column id beyond n_in
        _value_plan(ptr, cols, vals, 2, 40)
    with pytest.raises(ValueError):          # too few values
        _value_plan(ptr, cols, vals[:2], 2, 41)
    with pytest.raises(ValueError):          # ptr decreasing
        _value_plan(np.array([0, 3, 2]), cols, vals, 2, 41)
    with pytest.raises(TypeError):           # int64 index arrays
        vp.build_plan(torch.from_numpy(ptr), torch.from_numpy(cols), None,
                      2, 41)
    launches = vp.spmv_value_pull.launches
    vp.spmv_value_pull(plan, torch.zeros(41))
    assert vp.spmv_value_pull.launches == launches   # plain runs count 0
    empty = _value_plan(np.zeros(1, np.int64), np.zeros(0), None, 0, 41)
    assert vp.spmv_value_pull(empty, torch.zeros(41)).shape == (0,)


def test_library_name_hashes_its_own_source(tmp_path, monkeypatch):
    """Editing or adding one CUDA source renames only its own library, so
    the others are not rebuilt; editing a header renames the library of
    every source that includes it, and only those."""
    from graphblast_tpu_torch.ops.kernels import _build

    for src in os.listdir(_build.CSRC_DIR):
        (tmp_path / src).write_text(
            open(os.path.join(_build.CSRC_DIR, src)).read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = tmp_path / "row_schedule.cuh"
    header.write_text(header.read_text() + "// edited\n")
    users = {"value_pull", "monoid_pull", "bitmap_pull", "minmax_pull"}
    for n in _build.SOURCES:
        assert (_build.library_path(n) != before[n]) == (n in users), n
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    (tmp_path / "value_pull.cu").write_text("// edited\n")
    (tmp_path / "other.cu").write_text("// a new source\n")
    monkeypatch.setitem(_build.SOURCES, "other", "other.cu")
    assert _build.library_path("bitmap_pull") == before["bitmap_pull"]
    assert _build.library_path("value_pull") != before["value_pull"]
    assert len({_build.library_path(n) for n in _build.SOURCES}) == len(
        _build.SOURCES)


PORT_MODULES = [
    "graphblast_tpu_torch",
    "graphblast_tpu_torch.types",
    "graphblast_tpu_torch.semiring",
    "graphblast_tpu_torch.config",
    "graphblast_tpu_torch.descriptor",
    "graphblast_tpu_torch.dimension",
    "graphblast_tpu_torch.io.mmio",
    "graphblast_tpu_torch.io.cache",
    "graphblast_tpu_torch.io.rmat",
    "graphblast_tpu_torch.matrix",
    "graphblast_tpu_torch.vector",
    "graphblast_tpu_torch.operations",
    "graphblast_tpu_torch.ops.spmv",
    "graphblast_tpu_torch.ops.segops",
    "graphblast_tpu_torch.ops.spmspv",
    "graphblast_tpu_torch.ops.dispatch",
    "graphblast_tpu_torch.ops.kernels._build",
    "graphblast_tpu_torch.ops.kernels.bitmap_pull",
    "graphblast_tpu_torch.ops.kernels.value_pull",
    "graphblast_tpu_torch.ops.kernels.monoid_pull",
    "graphblast_tpu_torch.ops.kernels.minmax_pull",
    "graphblast_tpu_torch.ops.kernels.orpull",
    "graphblast_tpu_torch.algorithms",
    "graphblast_tpu_torch.algorithms.bfs",
    "graphblast_tpu_torch.algorithms.pr",
    "graphblast_tpu_torch.algorithms.sssp",
    "graphblast_tpu_torch.algorithms.cc",
    "graphblast_tpu_torch.algorithms.common",
    "graphblast_tpu_torch.algorithms.reference",
    "graphblast_tpu_torch.algorithms.diameter",
    "graphblast_tpu_torch.utils",
    "graphblast_tpu_torch.utils.cli",
    "graphblast_tpu_torch.utils.verify",
    "graphblast_tpu_torch.utils.profiling",
    "graphblast_tpu_torch.examples._driver",
    "graphblast_tpu_torch.examples.gbfs",
    "graphblast_tpu_torch.examples.gsssp",
    "graphblast_tpu_torch.examples.gdiameter",
    "graphblast_tpu_torch.examples.gpr",
    "graphblast_tpu_torch.examples.gcc",
    "graphblast_tpu_torch.examples.gmis",
    "graphblast_tpu_torch.examples.ggc",
    "graphblast_tpu_torch.examples.ggc_cusparse",
    "graphblast_tpu_torch.examples.gtc",
    "graphblast_tpu_torch.examples.scaling",
    "graphblast_tpu_torch.examples.comm_report",
    "graphblast_tpu_torch.native",
    "graphblast_tpu_torch.parallel",
    "graphblast_tpu_torch.parallel.accounting",
    "graphblast_tpu_torch.parallel.algorithms",
    "graphblast_tpu_torch.parallel.bootstrap",
    "graphblast_tpu_torch.parallel.ops",
    "graphblast_tpu_torch.parallel.partition",
    "graphblast_tpu_torch.parallel.partition2d",
    "graphblast_tpu_torch.parallel.ring",
    "graphblast_tpu_torch.tools",
    "graphblast_tpu_torch.tools.build_memory",
    "graphblast_tpu_torch.tools.gen_rmat_cache",
    "graphblast_tpu_torch.tools.mtx_ingest_check",
    "chip_smoke",
]

_BLOCKED = """
import importlib, sys
for name in ("jax", "jaxlib", "graphblast_tpu"):
    sys.modules[name] = None     # any import of them now raises
for mod in {mods!r}:
    importlib.import_module(mod)
import numpy as np
import graphblast_tpu_torch as gt
from graphblast_tpu_torch.io.rmat import grid_matrix
A = grid_matrix(6, device="cpu")
desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY)
v = gt.algorithms.bfs(A, 0, desc).to_numpy()
assert np.array_equal(v, gt.algorithms.bfs_cpu(A, 0)), v
p = gt.algorithms.pr(A, eps=1e-6).to_numpy()
assert np.allclose(p, gt.algorithms.pr_cpu(A, eps=1e-12), rtol=1e-3), p
d = gt.algorithms.sssp(A, 0, gt.DEFAULT.replace(mxv_mode=gt.Direction.PULLONLY))
assert np.array_equal(d.to_numpy(), gt.algorithms.sssp_cpu(A, 0)), d
c = gt.algorithms.cc(A).to_numpy()
assert np.array_equal(c, gt.algorithms.cc_cpu(A)) and gt.verify_cc(A, c), c
push = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PUSHONLY)
v = gt.algorithms.bfs(A, 0, push).to_numpy()
assert np.array_equal(v, gt.algorithms.bfs_cpu(A, 0)), v
d = gt.algorithms.sssp(A, 0, gt.DEFAULT.replace(mxv_mode=gt.Direction.PUSHONLY))
assert np.array_equal(d.to_numpy(), gt.algorithms.sssp_cpu(A, 0)), d
v = gt.algorithms.bfs(A, 0).to_numpy()
assert np.array_equal(v, gt.algorithms.bfs_cpu(A, 0)), v
d = gt.algorithms.sssp(A, 0).to_numpy()
assert np.array_equal(d, gt.algorithms.sssp_cpu(A, 0)), d
assert gt.diameter(A, 0, 3) == (10, 0)
from graphblast_tpu_torch.examples import gbfs
assert gbfs.main(["rmat:6:4", "--device", "cpu", "--niter", "1"]) == 0
assert not any(m == "jax" or m.startswith(("jax.", "graphblast_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_never_imports_jax():
    """Every port module, chip_smoke.py, a BFS, a PageRank, an SSSP and a CC
    run, a push-only and a default (PUSHPULL) BFS and SSSP, diameter and
    the gbfs driver, with jax and graphblast_tpu blocked in a fresh
    interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED.format(mods=PORT_MODULES)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "BFS: CORRECT" in out.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA: chip_smoke.py exits non-zero and prints no result, in the
    repo and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without CUDA")
    src = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for script, cwd in ((src, REPO), (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
