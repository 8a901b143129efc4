"""Device milliseconds of the push a BFS call, over the traced calls: for
each "gb.bfs.iter" span of the program that holds a "gb.push", the device's
busy time (torch.profiler) from the end of the iteration's
"gb.dispatch.read" to the iteration's end, summed and divided by the calls.
The dispatch's host read drains the stream before the push is enqueued and
the loop's read of succ drains it after, so the interval holds the push's
device work alone. Layer: push (ops/dispatch.py mxv_dual -> _push,
ops/spmspv.py, K6)."""
import numpy as np

from gbench.readers import call_depths

ITER, READ, PUSH = "gb.bfs.iter", "gb.dispatch.read", "gb.push"


def spans(ts, name) -> tuple:
    """(starts, ends) of the host spans called `name`, by start."""
    idx = np.asarray([i for i, k in enumerate(ts.cpu_name) if k == name],
                     dtype=np.int64)
    order = np.argsort(ts.cpu_start[idx], kind="stable")
    return ts.cpu_start[idx][order], ts.cpu_end[idx][order]


def read(run, st):
    ts = run.trace_summary
    depths = call_depths(st)
    if ts is None or not len(ts.dev_start) or len(ts.calls) != len(depths):
        return None
    it_s, it_e = spans(ts, ITER)
    if not len(it_s):
        return None
    read_e = np.sort(spans(ts, READ)[1])
    push_s = spans(ts, PUSH)[0]
    total = 0.0
    for (c0, c1), depth in zip(ts.calls, depths):
        inside = np.nonzero((it_s >= c0) & (it_e <= c1))[0]
        if len(inside) != depth:
            return None
        for i in inside:
            lo, hi = it_s[i], it_e[i]
            push = push_s[(push_s >= lo) & (push_s <= hi)]
            if not len(push):
                continue
            before = read_e[(read_e >= lo) & (read_e <= push[0])]
            if not len(before):
                return None
            total += ts.busy_s(before[-1], hi)
    return total / len(ts.calls) * 1e3
