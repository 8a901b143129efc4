"""PageRank on the prepared matrix, in a closed loop by one caller (GAP's
pr, GraphBLAST's `gpr`): in set-up `P = prepare_pr_matrix(A, alpha)` (the
GraphBLAS prep of example/gpr.cu:82-98, on the card) and its pull plan; in
the window `graphblast_tpu_torch.algorithms.pr.pr(P, alpha, eps,
prepared=True)`, the call GraphBLAST's gpr times. A control run puts the
reference's bfloat16 loop in the program's place.

Traffic keys: "alpha", "eps", "max_niter" (the program's default), "sample"
(calls compared with the reference), "trace_calls" (calls in a traced
window), "limits" (the limit of each number compared).
"""
from __future__ import annotations

import random
import sys
import types

import torch

from gbench import harness
from gbench.readers import VALUE_PULL
from gbench.reference import pr as ref

COUNTERS = VALUE_PULL    # the check reads the iterations a call ran


def setup(run):
    g, t = run.graph, run.traffic
    st = types.SimpleNamespace(alpha=float(t["alpha"]), eps=float(t["eps"]))
    if run.control:
        _, stop, _ = ref.iterates(g, st.alpha, st.eps, int(t["max_niter"]))
        # bfloat16 iterates may never settle under eps: capped past K
        st.once = lambda: ref.control(g, st.alpha, st.eps, stop + 1)
    else:
        from graphblast_tpu_torch.algorithms.pr import pr, prepare_pr_matrix
        from graphblast_tpu_torch.matrix import Matrix
        from graphblast_tpu_torch.ops.kernels.value_pull import plan_for

        with run.span("build_s"):
            ones = torch.ones(g.m, dtype=torch.float32, device=run.device)
            A = Matrix.from_device_coo(g.rows, g.cols, ones, g.n, g.n)
            del ones
        with run.span("plan_s"):
            st.P = prepare_pr_matrix(A, st.alpha)
            del A
            plan_for(st.P, transpose=True)
        st.once = lambda: pr(st.P, st.alpha, st.eps, prepared=True).dense
        for _ in range(2):
            st.once()
    st.sample = harness.Sample(int(t["sample"]), random.Random(run.seed))
    return st


def call(run, st, k):
    return st.once()


def keep(run, st, k, out):
    st.sample.offer(k, out)


def free(run, st):
    """Drop the program; the kept results go to the host, so that none
    holds one of the program's segments on the card."""
    st.P = st.once = None
    st.sample.kept = {k: v.cpu() for k, v in st.sample.kept.items()}


def end_to_end(run, st):
    return {"pr_ms": run.window_s / len(run.latencies) * 1e3}


def checks(run, st):
    """{"pr_rel_l1_max": the largest, over the sampled calls, of the
    relative L1 distance to the float64 reference's iterate at its stop K,
    "pr_iters_off": how far the value pulls a call, by the program's
    counter, lie from K}, with their limits, and the calls found wrong.
    An iterate or count one either side of K is taken only where the
    float64 err at that boundary lies within float32 rounding of eps. The
    program counts its launches on the card alone: on the CPU, where the
    tests run its plain versions, a counter that has not moved is not
    compared."""
    limit = float(run.traffic["limits"]["pr_rel_l1_max"])
    its, stop, errs = ref.iterates(run.graph, st.alpha, st.eps,
                                   int(run.traffic["max_niter"]))
    allowed = ref.stops(stop, errs, st.eps)
    print(f"gbench: the float64 loop stops at K = {stop}; err "
          f"{errs.get(stop - 1)!r} at K - 1, {errs[stop]!r} at K, "
          f"{errs[stop + 1]!r} at K + 1, eps {st.eps!r}; stops compared "
          f"{allowed}", file=sys.stderr)
    worst, wrong = 0.0, 0
    for k, out in sorted(st.sample.kept.items()):
        d = min(ref.rel_l1(out, its[s]) for s in allowed)
        worst = max(worst, d)
        wrong += d > limit
    if st.sample.kept:
        first = st.sample.kept[min(st.sample.kept)]
        print("gbench: a sampled call's relative L1 to the float64 iterate "
              + ", ".join(f"p_{s} {ref.rel_l1(first, p)!r}"
                          for s, p in sorted(its.items())), file=sys.stderr)
    out = {"pr_rel_l1_max": (worst, limit)}
    pulls = run.launches.get("value_pull", 0)
    if (run.device.type == "cuda" or pulls) and run.latencies:
        iters = pulls / len(run.latencies)
        out["pr_iters_off"] = (min(abs(iters - s) for s in allowed), 0)
    return out, wrong
