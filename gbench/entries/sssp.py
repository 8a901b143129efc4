"""SSSP from a fixed set of roots, cycled in order by one caller (Graph500
kernel 3, GAP's sssp): `graphblast_tpu_torch.algorithms.sssp.sssp(A, root,
desc)` with the traffic's descriptor, on the weighted graph.

Traffic keys: as the bfs entry's ("roots", "roots_seed",
"root_min_degree", "descriptor", "sample", "trace_calls").

The edges a call traverses are the stored edges of the vertices it
reaches, a distance under FLT_MAX (its root's component), counted as for
BFS. Every call's reached set is checked by its edge count against that; a
sample of calls, drawn from the seed, is compared vertex by vertex with the
reference's float32 distances, exactly. A control run puts the reference
with its last improving pass left undone in the program's place.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import random
import types

import torch

from gbench import harness
from gbench.reference import sssp as ref

# the bfs entry beside this file, used as a library: its component edges,
# roots, TEPS and p95 (`root_of`, `end_to_end`, `_component_edges`), so an
# edit there changes this cell's metrics and checks too
_BFS = harness.load_module(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "entries", "bfs")
root_of = _BFS.root_of


def _control(g, root, desc):
    return types.SimpleNamespace(dense=ref.last_pass_undone(g, root))


def setup(run):
    g, t = run.graph, run.traffic
    draw = random.Random(run.seed)
    roots = harness.draw_roots(g, t)
    st = types.SimpleNamespace(roots=draw.sample(roots, len(roots)))
    # a window runs whole pairs of cycles of the roots: four cycles in
    # 35 s, so that a run averages the host's and the card's drift over
    # more of them (a cycle takes some 13 s)
    st.cycle = 2 * len(st.roots)
    if run.control:
        st.sssp, st.A, st.desc = _control, g, None
    else:
        from graphblast_tpu_torch import descriptor
        from graphblast_tpu_torch.algorithms.sssp import sssp
        from graphblast_tpu_torch.matrix import Matrix
        from graphblast_tpu_torch.ops.kernels.monoid_pull import \
            plan_for_monoid

        st.sssp, st.desc = sssp, getattr(descriptor, t["descriptor"])
        with run.span("build_s"):
            st.A = Matrix.from_device_coo(g.rows, g.cols, g.w, g.n, g.n)
        with run.span("plan_s"):
            plan_for_monoid(st.A, transpose=True)
        # warm-up: the first 4 roots of the cycle, so that the pull, the
        # push and its slices are built and allocated before the window
        for r in st.roots[:4]:
            st.sssp(st.A, r, st.desc)
        # the program holds its own copy: the window keeps no weights
        run.graph = dataclasses.replace(g, w=None)
    st.sample = harness.Sample(int(t["sample"]), draw)
    st.reached = []
    st.iters, st.cur_iters = {}, []
    return st


def trace_on(run, st):
    """Record the relaxations the loop itself counts in each call."""
    mod = importlib.import_module("graphblast_tpu_torch.algorithms.sssp")
    inner = mod._sssp_fused

    def counting(*args, **kw):
        v, iters = inner(*args, **kw)
        st.cur_iters.append(iters)
        return v, iters

    mod._sssp_fused = counting
    st.untrace = lambda: setattr(mod, "_sssp_fused", inner)


def call(run, st, k):
    return st.sssp(st.A, root_of(st, k), st.desc).dense


def keep(run, st, k, out):
    # the stored edges of the reached vertices, on the device, read later
    st.reached.append((run.graph.deg * (out < ref.FLT_MAX)).sum())
    st.sample.offer(k, out)
    if run.trace:
        st.iters[k], st.cur_iters = sum(st.cur_iters), []


def free(run, st):
    """Drop the program, and move what the check keeps to the host, so
    that no kept output holds one of the program's segments on the card
    while the graph is drawn again."""
    if hasattr(st, "untrace"):
        st.untrace()
    st.A = None
    st.reached = torch.stack(st.reached).cpu() if st.reached else None
    st.sample.kept = {k: v.cpu() for k, v in st.sample.kept.items()}


def end_to_end(run, st):
    """Graph500's TEPS for kernel 3, counted as for kernel 2 (the bfs
    entry): the edges each call traversed over the window, and the p95 of
    the calls' latencies."""
    return _BFS.end_to_end(run, st)


def checks(run, st):
    """{"dist_mismatch_max": the most vertices of a sampled call whose
    float32 distance differs from the reference's, "calls_off_edges":
    calls whose reached vertices' edges differ from their root's
    component's}, each with limit 0, and the calls found wrong."""
    edges = _BFS._component_edges(run, st)
    calls = len(run.latencies)
    want = edges[torch.tensor([root_of(st, k) for k in range(calls)],
                              device=edges.device, dtype=torch.long)].cpu()
    got = st.reached if calls else want
    wrong = set(torch.nonzero(got != want).flatten().tolist())
    off_edges = len(wrong)
    worst = 0
    for k, out in sorted(st.sample.kept.items()):
        d = ref.distances(run.graph, root_of(st, k))
        miss = int((out.to(d.device) != d).sum())
        worst = max(worst, miss)
        if miss:
            wrong.add(k)
    return ({"dist_mismatch_max": (worst, 0),
             "calls_off_edges": (off_edges, 0)}, len(wrong))
