"""What the SSSP cell's span readers share: the program's iteration spans
of each traced call, checked against the relaxations the loop itself
counted (the sssp entry's st.iters)."""
from __future__ import annotations

import os

import numpy as np

from gbench import harness

ITER, READ, PUSH = "gb.sssp.iter", "gb.dispatch.read", "gb.push"
# (starts, ends) of the host spans of a name, by start: the BFS push
# reader's, beside this file, used as a library, so an edit to
# metrics/push_ms_per_call.bfs.py's `spans` changes the SSSP readers too
spans = harness.load_module(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics", "push_ms_per_call.bfs").spans


def call_iterations(run, st):
    """For each traced call, in order, the indices (into `spans(ts, ITER)`)
    of its "gb.sssp.iter" spans; None where the trace holds no such span,
    or where a call's count differs from the relaxations its loop
    returned."""
    ts = run.trace_summary
    iters = getattr(st, "iters", None) or {}
    if ts is None or len(ts.calls) != len(iters):
        return None
    it_s, it_e = spans(ts, ITER)
    if not len(it_s):
        return None
    out = []
    for (c0, c1), k in zip(ts.calls, sorted(iters)):
        inside = np.nonzero((it_s >= c0) & (it_e <= c1))[0]
        if len(inside) != iters[k]:
            return None
        out.append(inside)
    return out
