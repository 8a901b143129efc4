"""On the card: the SSSP cell at a small scale, traced and not, correct
and with every metric, and the program's SSSP spans, which add no device
activity to a trace. Run there with `python3 -m pytest gbench/tests -m
cuda`."""
import importlib

import pytest
import torch

from gbench import harness, trace

CELL = "kron25-sssp"


@pytest.mark.cuda
@pytest.mark.parametrize("trace_on", [0, 1])
def test_sssp_cell_on_the_card(tiny_root, trace_on):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = harness.run_cell(CELL, 2**31 + 3, 0.5, trace_on, "cuda:0",
                           root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    bench = harness.load_bench(tiny_root)
    want = {m["name"] for m in harness.metrics_of(bench, CELL, bool(trace_on))}
    if not trace_on:
        assert set(out["metrics"]) == want
        return
    assert out["device"]["busy_s"] > 0
    # the roofline share is absent only where no card's peaks are known
    assert want - set(out["metrics"]) <= {"pull_roofline_share.sssp"}
    share = out["metrics"].get("pull_roofline_share.sssp", {"value": 1})
    assert 0 < share["value"] <= 100


@pytest.mark.cuda
def test_sssp_spans_add_no_device_activity():
    """A profiled PUSHPULL sssp() on the card: the trace's reduction holds
    the loop's spans among its host ops and no device event named after
    one of the program's spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile

    from graphblast_tpu_torch.io.rmat import rmat_matrix

    sssp = importlib.import_module("graphblast_tpu_torch.algorithms.sssp")
    A = rmat_matrix(12, 16, seed=1, device="cuda")
    hub = int(torch.argmax(torch.diff(A.row_ptr[:A.nrows + 1])))
    sssp.sssp(A, hub)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function(trace.CALL):
                sssp.sssp(A, hub)
                torch.cuda.synchronize()
    ts = trace.reduce(prof)
    assert ts is not None and len(ts.dev_name) > 0
    assert not [k for k in ts.dev_name if k.startswith("gb.")]
    for name in ("gb.sssp.iter", "gb.sssp.read", "gb.dispatch.read",
                 "gb.push", "gb.pull"):
        assert name in ts.cpu_name
