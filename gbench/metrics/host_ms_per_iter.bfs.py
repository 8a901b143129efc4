"""Host milliseconds a BFS iteration: over the traced calls, (the calls'
wall time - the device's busy time inside them) / their iterations. The
device's busy time is the union of its operations in each call's span
(torch.profiler). Layer: algorithm loop and the push's host path
(algorithms/bfs.py, ops/dispatch.py, ops/spmspv.py)."""
from gbench.readers import call_depths


def read(run, st):
    ts = run.trace_summary
    depths = call_depths(st)
    if ts is None or not len(ts.dev_start) or len(ts.calls) != len(depths):
        return None
    host = sum((e - s) - ts.busy_s(s, e) for s, e in ts.calls)
    return host / sum(depths) * 1e3 if sum(depths) else None
