"""BFS from a fixed set of roots, cycled in order by one caller (Graph500
kernel 2, GAP's bfs): `graphblast_tpu_torch.algorithms.bfs.bfs(A, root,
desc)` with the traffic's descriptor.

Traffic keys: "roots" (how many, drawn from "roots_seed" among the vertices
of at least "root_min_degree" edges, without repeats; --seed orders them),
"descriptor" (a name in
graphblast_tpu_torch.descriptor), "sample" (calls whose levels are compared
with the reference), "trace_calls" (calls in a traced window).

The edges a call traverses are the stored edges of the vertices it reaches
(its root's component), from the benchmark's own components. Every call's
reached set is checked by its edge count against that; a sample of calls,
drawn from the seed, is compared level by level with the reference. A
control run puts the reference with its deepest level dropped in the
program's place.
"""
from __future__ import annotations

import random
import types

import torch

from gbench import graphs, harness
from gbench.reference import bfs as ref


def _control(g, root, desc):
    return types.SimpleNamespace(
        dense=ref.levels_last_dropped(g, root).to(torch.float32))


def setup(run):
    g, t = run.graph, run.traffic
    draw = random.Random(run.seed)
    roots = harness.draw_roots(g, t)
    st = types.SimpleNamespace(roots=draw.sample(roots, len(roots)))
    st.cycle = len(st.roots)      # a window runs whole cycles of the roots
    if run.control:
        st.bfs, st.A, st.desc = _control, g, None
    else:
        from graphblast_tpu_torch import descriptor
        from graphblast_tpu_torch.algorithms.bfs import bfs, bfs_pull_plan
        from graphblast_tpu_torch.matrix import Matrix

        st.bfs, st.desc = bfs, getattr(descriptor, t["descriptor"])
        with run.span("build_s"):
            ones = torch.ones(g.m, dtype=torch.float32, device=run.device)
            st.A = Matrix.from_device_coo(g.rows, g.cols, ones, g.n, g.n)
            del ones
        with run.span("plan_s"):
            bfs_pull_plan(st.A, st.desc)
        # warm-up: one cycle of the roots, so that every push workspace and
        # kernel the window meets is built and allocated
        for r in st.roots:
            st.bfs(st.A, r, st.desc)
    st.sample = harness.Sample(int(t["sample"]), draw)
    st.reached = []
    st.levels, st.words, st.cur_words = {}, {}, []
    return st


def trace_on(run, st):
    """Record the frontier bitmap of each K1 launch (the pull), so that
    the pull's least bytes can be counted from the levels afterwards."""
    from graphblast_tpu_torch.ops import dispatch

    inner = dispatch.spmv_bitmap_pull

    def recording(plan, words):
        st.cur_words.append(words)
        return inner(plan, words)

    dispatch.spmv_bitmap_pull = recording
    st.untrace = lambda: setattr(dispatch, "spmv_bitmap_pull", inner)


def call(run, st, k):
    return st.bfs(st.A, root_of(st, k), st.desc).dense


def keep(run, st, k, out):
    # the stored edges of the reached vertices, on the device, read later
    st.reached.append((run.graph.deg * (out > 0)).sum())
    st.sample.offer(k, out)
    if run.trace:
        st.levels[k] = out.to(torch.int8)    # readers refuse a level that wrapped
        st.words[k], st.cur_words = st.cur_words, []


def free(run, st):
    """Drop the program, and move what the check and the readers keep to
    the host, so that no kept output holds one of the program's segments on
    the card while the graph is drawn again."""
    if hasattr(st, "untrace"):
        st.untrace()
    st.A = None
    st.reached = torch.stack(st.reached).cpu() if st.reached else None
    st.sample.kept = {k: v.cpu() for k, v in st.sample.kept.items()}
    st.levels = {k: v.cpu() for k, v in st.levels.items()}
    st.words = {k: [w.cpu() for w in ws] for k, ws in st.words.items()}


def _component_edges(run, st):
    if not hasattr(st, "comp_edges"):
        label = graphs.components(run.graph)
        st.comp_edges = graphs.component_edges(run.graph, label)
    return st.comp_edges


def root_of(st, k):
    return st.roots[k % len(st.roots)]


def end_to_end(run, st):
    edges = _component_edges(run, st)
    per_root = edges[torch.tensor(st.roots, device=edges.device)].tolist()
    total = sum(per_root[k % len(st.roots)] for k in range(len(run.latencies)))
    lat = sorted(run.latencies)
    return {"bfs_gteps": total / run.window_s / 1e9,
            "bfs_p95_ms": percentile(lat, 95.0) * 1e3}


def percentile(sorted_values: list, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    pos = (len(sorted_values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (
        pos - lo)


def checks(run, st):
    """{"level_mismatch_max": the most vertices of a sampled call whose
    level differs from the reference's, "calls_off_edges": calls whose
    reached vertices' edges differ from their root's component's}, each
    with limit 0, and the calls found wrong."""
    edges = _component_edges(run, st)
    calls = len(run.latencies)
    want = edges[torch.tensor([root_of(st, k) for k in range(calls)],
                              device=edges.device, dtype=torch.long)].cpu()
    got = st.reached if calls else want
    wrong = set(torch.nonzero(got != want).flatten().tolist())
    off_edges = len(wrong)
    worst = 0
    for k, out in sorted(st.sample.kept.items()):
        lv = ref.levels(run.graph, root_of(st, k)).to(torch.float32)
        miss = int((out.to(lv.device) != lv).sum())
        worst = max(worst, miss)
        if miss:
            wrong.add(k)
    return ({"level_mismatch_max": (worst, 0),
             "calls_off_edges": (off_edges, 0)}, len(wrong))
