"""The push's per-layer metrics: push_ms_per_call.bfs on hand-made traces,
the two counter readers on the tiny CPU run, and, on the card, that the
program's spans add no device activity to a trace."""
import types

import numpy as np
import pytest
import torch

from gbench import harness, trace

PUSH_MS = harness.load_module(harness.ROOT, "metrics", "push_ms_per_call.bfs")
LANE_USE = harness.load_module(harness.ROOT, "metrics", "push_lane_use.bfs")
TOP_TIER = harness.load_module(harness.ROOT, "metrics",
                               "top_tier_pushes_per_call.bfs")

# two calls: the first pushes then pulls (2 iterations), the second pushes
CPU = [("gbench.call", 0.0, 40.0),
       ("gb.bfs.iter", 1.0, 10.0), ("gb.dispatch.read", 2.0, 4.0),
       ("gb.push", 4.0, 6.0), ("gb.bfs.read", 6.0, 9.0),
       ("gb.bfs.iter", 11.0, 30.0), ("gb.dispatch.read", 12.0, 14.0),
       ("gb.pull", 14.0, 20.0), ("gb.bfs.read", 20.0, 29.0),
       ("gbench.call", 50.0, 70.0),
       ("gb.bfs.iter", 51.0, 69.0), ("gb.dispatch.read", 52.0, 55.0),
       ("gb.push", 55.0, 60.0), ("gb.bfs.read", 60.0, 68.0)]
# before each dispatch read ends: the frontier's state, not the push; the
# push's work in 4.5-9.5 and 56-61; the pull's in 15-25
DEV = [("deg", 3.0, 4.0), ("sort", 4.5, 8.0), ("fill", 7.5, 9.5),
       ("K1", 15.0, 25.0), ("deg", 53.0, 54.5), ("sort", 56.0, 61.0)]


def _run(cpu, dev, depths):
    calls = [(s, e) for n, s, e in cpu if n == "gbench.call"]
    ts = trace.Trace((0.0, 100.0), calls, np.array([d[1] for d in dev]),
                     np.array([d[2] for d in dev]), [d[0] for d in dev],
                     np.array([c[1] for c in cpu]),
                     np.array([c[2] for c in cpu]), [c[0] for c in cpu])
    levels = {k: torch.arange(1, d + 1, dtype=torch.int8)
              for k, d in enumerate(depths)}
    return (types.SimpleNamespace(trace_summary=ts),
            types.SimpleNamespace(levels=levels))


def test_push_ms_per_call_sums_the_push_intervals():
    run, st = _run(CPU, DEV, [2, 1])
    # (9.5 - 4.5) + (61 - 56) seconds over 2 calls
    assert PUSH_MS.read(run, st) == pytest.approx(5000.0)


@pytest.mark.parametrize("cpu,dev,depths", [
    (CPU, DEV, [2, 2]),                          # a call's spans disagree
    (CPU, DEV, [1, 1]),
    ([c for c in CPU if c[0] != "gb.bfs.iter"], DEV, [2, 1]),   # no spans
    (CPU, [], [2, 1]),                           # no device: a CPU run
    ([c for c in CPU if c[0] != "gb.dispatch.read"], DEV, [2, 1]),
])
def test_push_ms_per_call_is_none_where_it_cannot_read(cpu, dev, depths):
    run, st = _run(cpu, dev, depths)
    assert PUSH_MS.read(run, st) is None


def test_counter_readers_on_their_counts():
    run = types.SimpleNamespace(latencies=[0.1] * 4, launches={
        "push_edges": 30, "push_lanes": 120, "top_tier_pushes": 2})
    assert LANE_USE.read(run, None) == 25.0
    assert TOP_TIER.read(run, None) == 0.5
    # a program without the counters (the parent of the push's metrics)
    bare = types.SimpleNamespace(latencies=[0.1] * 4, launches={})
    assert LANE_USE.read(bare, None) is None
    assert TOP_TIER.read(bare, None) is None


@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs"])
def test_counter_readers_in_the_tiny_traced_run(tiny_root, cell):
    """The traced run on the CPU reports both counter metrics, and no
    device metric: a CPU trace holds no device time."""
    out = harness.run_cell(cell, 2**31 + 11, 0.2, True, "cpu",
                           root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    assert 0 < got["push_lane_use.bfs"]["value"] <= 100
    top = got["top_tier_pushes_per_call.bfs"]["value"] * out["attempted"]
    assert top == pytest.approx(round(top)) and top >= 0
    assert "push_ms_per_call.bfs" not in got


@pytest.mark.cuda
def test_program_spans_add_no_device_activity():
    """A profiled PUSHPULL bfs() on the card: the trace's reduction holds
    the program's spans among its host ops and no device event named
    after one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile

    import graphblast_tpu_torch as gt
    from graphblast_tpu_torch.io.rmat import rmat_matrix

    A = rmat_matrix(12, 16, seed=1, device="cuda")
    gt.algorithms.bfs(A, 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function(trace.CALL):
                gt.algorithms.bfs(A, 0)
                torch.cuda.synchronize()
    ts = trace.reduce(prof)
    assert ts is not None and len(ts.dev_name) > 0
    assert not [k for k in ts.dev_name if k.startswith("gb.")]
    for name in ("gb.bfs.iter", "gb.bfs.read", "gb.dispatch.read",
                 "gb.push", "gb.pull"):
        assert name in ts.cpu_name
