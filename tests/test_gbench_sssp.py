"""The benchmark's `kron25-sssp` cell on the CPU, at 2^10 vertices: a run
through the harness, traced and not, correct and with the cell's metrics;
its control and a planted fault, each not correct; and each of the cell's
new per-layer readers on a hand-made run. No JAX: the harness refuses a
run that loads it."""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from gbench import control, harness, trace
from graphblast_tpu_torch.matrix import Matrix

CELL = "kron25-sssp"
TINY = os.path.join(harness.ROOT, "gbench", "tests", "gbench_tiny.py")


def _metric(name):
    return harness.load_module(harness.ROOT, "metrics", name)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("gbench_tiny_sssp", TINY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_root(tmp_path_factory.mktemp("gbench_tiny_sssp"))


def test_cell_is_declared_with_its_metrics():
    bench = harness.load_bench()
    cell, config, traffic = harness.resolve(bench, CELL)
    assert cell["chips"] == 1 and config["generator"] == "kron_weighted"
    assert traffic["entry"] == "sssp" and traffic["descriptor"] == "DEFAULT"
    assert {m["name"] for m in harness.metrics_of(bench, CELL, False)} == {
        "bfs_gteps", "bfs_p95_ms", "setup_s"}
    traced = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
    assert traced == {"build_s", "plan_s", "iters_per_call.sssp",
                      "pulls_per_call.sssp", "pull_roofline_share.sssp",
                      "push_ms_per_call.sssp",
                      "top_tier_pushes_per_call.sssp",
                      "device_idle_share.sssp",
                      "masked_pulls_per_call.sssp"}
    # the same graph, roots and root rule as kron25-bfs
    _, kron, bfs = harness.resolve(bench, "kron25-bfs")
    for key in ("graph_seed", "scale", "edge_factor", "A", "B", "C"):
        assert config[key] == kron[key]
    for key in ("roots", "roots_seed", "root_min_degree"):
        assert traffic[key] == bfs[key]


@pytest.mark.parametrize("trace_on", [0, 1])
def test_cell_runs_correct_on_the_cpu(tiny_root, trace_on):
    out = harness.run_cell(CELL, 2**31 + 13, 0.2, trace_on, "cpu",
                           root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["checks"] == {"dist_mismatch_max": {"value": 0, "limit": 0},
                             "calls_off_edges": {"value": 0, "limit": 0}}
    got = out["metrics"]
    if not trace_on:
        assert set(got) == {"bfs_gteps", "bfs_p95_ms", "setup_s"}
        assert out["attempted"] % 64 == 0 and got["bfs_gteps"]["value"] > 0
        return
    assert out["attempted"] == 16
    # a CPU trace holds no device time and the CPU no peaks: the device
    # readers stay out; the plain K4 counts no launch
    assert set(got) == {"build_s", "plan_s", "iters_per_call.sssp",
                        "pulls_per_call.sssp",
                        "top_tier_pushes_per_call.sssp",
                        "masked_pulls_per_call.sssp"}
    assert got["iters_per_call.sssp"]["value"] > 1
    assert got["pulls_per_call.sssp"]["value"] == 0
    assert got["masked_pulls_per_call.sssp"]["value"] == 0


def test_traced_iterations_equal_the_loops_own_count(tiny_root, monkeypatch):
    """iters_per_call.sssp reads the spans; the loop's own count of its
    relaxations, returned by _sssp_fused, gives the same mean."""
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.sssp")
    inner, counts = mod._sssp_fused, []

    def counting(*args, **kw):
        v, iters = inner(*args, **kw)
        counts.append(iters)
        return v, iters

    monkeypatch.setattr(mod, "_sssp_fused", counting)
    out = harness.run_cell(CELL, 2**31 + 17, 0.2, True, "cpu",
                           root=tiny_root)
    window = counts[-16:]
    assert out["metrics"]["iters_per_call.sssp"]["value"] == pytest.approx(
        sum(window) / len(window))


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_control_is_not_correct(tiny_root, seed):
    out = control.run(CELL, seed, "cpu", root=tiny_root)
    assert not out["correct"]
    assert out["checks"]["dist_mismatch_max"]["value"] > 0


def _one_weight_off(monkeypatch):
    """The weight of one stored edge one higher: the edge (hub, leaf) from
    the hub to a vertex of one edge, which relaxes the leaf from the hub
    (sssp() runs fᵀ A), so that every path to the leaf takes it."""
    inner = Matrix.from_device_coo

    def build(rows, cols, vals, nrows, ncols, *args, **kw):
        deg = torch.bincount(rows.long(), minlength=nrows)
        hub = int(torch.argmax(deg))
        edge = int(torch.nonzero((rows == hub) & (deg[cols.long()] == 1))[0])
        vals = vals.clone()
        vals[edge] += 1
        return inner(rows, cols, vals, nrows, ncols, *args, **kw)

    monkeypatch.setattr(Matrix, "from_device_coo", staticmethod(build))


@pytest.mark.parametrize("trace_on", [0, 1])
def test_one_weight_off_is_not_correct(tiny_root, monkeypatch, trace_on):
    _one_weight_off(monkeypatch)
    out = harness.run_cell(CELL, 2**31 + 21, 0.2, trace_on, "cpu",
                           root=tiny_root)
    assert not out["correct"]
    assert out["checks"]["dist_mismatch_max"]["value"] > 0


# two calls: the first pushes then pulls (2 relaxations), the second pushes
CPU = [("gbench.call", 0.0, 40.0),
       ("gb.sssp.iter", 1.0, 10.0), ("gb.dispatch.read", 2.0, 4.0),
       ("gb.push", 4.0, 6.0), ("gb.sssp.read", 6.0, 9.0),
       ("gb.sssp.iter", 11.0, 30.0), ("gb.dispatch.read", 12.0, 14.0),
       ("gb.pull", 14.0, 20.0), ("gb.sssp.read", 20.0, 29.0),
       ("gbench.call", 50.0, 70.0),
       ("gb.sssp.iter", 51.0, 69.0), ("gb.dispatch.read", 52.0, 55.0),
       ("gb.push", 55.0, 60.0), ("gb.sssp.read", 60.0, 68.0)]
DEV = [("deg", 3.0, 4.0), ("expand", 4.5, 8.0), ("scatter", 7.5, 9.5),
       ("rows_kernel<MonoidFold<0, 0> >", 15.0, 25.0),
       ("long_rows_kernel<MonoidFold<0, 0> >", 25.0, 26.0),
       ("deg", 53.0, 54.5), ("expand", 56.0, 61.0)]


def _run(cpu=CPU, dev=DEV, iters=(2, 1), **kw):
    calls = [(s, e) for n, s, e in cpu if n == "gbench.call"]
    ts = trace.Trace((0.0, 100.0), calls, np.array([d[1] for d in dev]),
                     np.array([d[2] for d in dev]), [d[0] for d in dev],
                     np.array([c[1] for c in cpu]),
                     np.array([c[2] for c in cpu]), [c[0] for c in cpu])
    run = types.SimpleNamespace(trace_summary=ts, latencies=[0.1] * len(iters),
                                launches=kw.pop("launches", {}),
                                peaks=kw.pop("peaks", None),
                                graph=kw.pop("graph", None))
    return run, types.SimpleNamespace(iters=dict(enumerate(iters)))


def test_iters_reader_counts_the_spans():
    assert _metric("iters_per_call.sssp").read(*_run()) == 1.5


def test_push_ms_reader_sums_the_push_intervals():
    # (9.5 - 4.5) + (61 - 56) seconds over 2 calls
    assert _metric("push_ms_per_call.sssp").read(*_run()) == pytest.approx(
        5000.0)


def test_push_ms_reader_takes_the_state_read_with_succ():
    """Where the loop reads the next dispatch's state with succ, inside
    the iteration before, a push's interval starts at that read's end."""
    cpu = [("gbench.call", 0.0, 40.0),
           ("gb.sssp.iter", 1.0, 10.0), ("gb.dispatch.read", 2.0, 4.0),
           ("gb.push", 4.0, 6.0), ("gb.sssp.read", 6.0, 9.0),
           ("gb.dispatch.read", 7.0, 9.0),
           ("gb.sssp.iter", 11.0, 30.0), ("gb.push", 12.0, 14.0),
           ("gb.sssp.read", 20.0, 29.0), ("gb.dispatch.read", 21.0, 29.0)]
    dev = [("expand", 4.5, 6.5), ("state", 8.0, 8.5), ("expand", 12.5, 16.0),
           ("tail", 16.0, 18.0), ("state", 22.0, 22.5)]
    # (6.5 - 4.5) + (8.5 - 8) from 4 s, then (18 - 12.5) + (22.5 - 22)
    # from 9 s, over one call
    assert _metric("push_ms_per_call.sssp").read(
        *_run(cpu=cpu, dev=dev, iters=(2,))) == pytest.approx(8500.0)


@pytest.mark.parametrize("case", [
    dict(iters=(2, 2)),                    # the loop counted another number
    dict(iters=(1, 1)),
    dict(cpu=[c for c in CPU if c[0] != "gb.sssp.iter"]),   # the parent
    dict(iters=()),                        # an untraced entry
])
def test_span_readers_are_none_where_they_cannot_read(case):
    for name in ("iters_per_call.sssp", "push_ms_per_call.sssp"):
        assert _metric(name).read(*_run(**case)) is None


def test_push_ms_reader_needs_device_time_and_dispatch_reads():
    assert _metric("push_ms_per_call.sssp").read(*_run(dev=[])) is None
    bare = [c for c in CPU if c[0] != "gb.dispatch.read"]
    assert _metric("push_ms_per_call.sssp").read(*_run(cpu=bare)) is None


def test_counter_readers_on_their_counts():
    run, st = _run(launches={"monoid_pull": 9, "sliced_pushes": 1})
    assert _metric("pulls_per_call.sssp").read(run, st) == 4.5
    assert _metric("top_tier_pushes_per_call.sssp").read(run, st) == 0.5
    bare, st = _run()      # a program without the sliced push's counter
    assert _metric("top_tier_pushes_per_call.sssp").read(bare, st) is None


def test_idle_reader_on_the_trace():
    run, st = _run()
    busy = 1 + 5 + 10 + 1 + 1.5 + 5      # the union of DEV
    assert _metric("device_idle_share.sssp").read(run, st) == pytest.approx(
        100.0 * (1 - busy / 100.0))


def test_roofline_reader_on_its_kernels():
    from gbench import roofline_monoid

    g = types.SimpleNamespace(n=1000, m=16000)
    peaks = {"bytes_per_s": 1e5, "fp32_flop_per_s": 1e9}
    run, st = _run(launches={"monoid_pull": 2}, peaks=peaks, graph=g)
    one = roofline_monoid.monoid_pull_least_bytes(1000, 1000, 16000)
    assert one == 8 * 16000 + 4 * 1001 + 8000
    # two pulls' least time over K4's 11 s
    share = _metric("pull_roofline_share.sssp").read(run, st)
    assert share == pytest.approx(100.0 * 2 * one / 1e5 / 11.0)
    # more launches than K4 kernels, no peaks, no launches: nothing to read
    for kw in (dict(launches={"monoid_pull": 3}, peaks=peaks, graph=g),
               dict(launches={"monoid_pull": 2}, graph=g),
               dict(peaks=peaks, graph=g)):
        assert _metric("pull_roofline_share.sssp").read(*_run(**kw)) is None
