"""Device milliseconds of the push an SSSP call, over the traced calls: for
each "gb.sssp.iter" span of the program that holds a "gb.push", the
device's busy time (torch.profiler) from the end of the call's last
"gb.dispatch.read" before the push (in the iteration, or at the end of the
one before, where the loop reads the dispatch's state with succ) to the
iteration's end, summed and divided by the calls. That read drains the
stream before the push is enqueued and the loop's read of succ drains it
after, so the interval holds the push's device work, the relaxation of v
after it and the next state's reduction. Layer: push (ops/dispatch.py
mxv_dual, ops/spmspv.py, K6)."""
import numpy as np

from gbench.sssp_spans import ITER, PUSH, READ, call_iterations, spans


def read(run, st):
    ts = run.trace_summary
    per_call = call_iterations(run, st)
    if not per_call or not len(ts.dev_start):
        return None
    it_s, it_e = spans(ts, ITER)
    read_e = np.sort(spans(ts, READ)[1])
    push_s = spans(ts, PUSH)[0]
    total = 0.0
    for inside in per_call:
        for i in inside:
            lo, hi = it_s[i], it_e[i]
            push = push_s[(push_s >= lo) & (push_s <= hi)]
            if not len(push):
                continue
            before = read_e[(read_e >= it_s[inside[0]])
                            & (read_e <= push[0])]
            if not len(before):
                return None
            total += ts.busy_s(before[-1], hi)
    return total / len(per_call) * 1e3
