"""NumPy golden references (counterpart of
graphblast_tpu/algorithms/reference.py; reference:
graphblas/algorithm/test_bfs.hpp, test_sssp.hpp, test_pr.hpp, test_cc.hpp,
test_mis.hpp, test_gc.hpp). They read host CSR arrays only. All but the
greedy MIS and colouring goldens are vectorised, so that they run at RMAT
scale 18 in seconds; those two visit the vertices in a seeded random order,
one at a time, as the JAX goldens do.
"""
from __future__ import annotations

import numpy as np

MAXF = float(np.finfo(np.float32).max)


def _csr(A):
    """Accept a Matrix or a (row_ptr, col_ind, val, n) tuple."""
    if isinstance(A, tuple):
        return A
    ptr, ci, v = A.host_csr()
    return ptr, ci, v, A.nrows


def _out_edges(rp: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    """The CSR slots of every out-edge of the `frontier` vertices, as one
    flat index array."""
    starts = rp[frontier]
    counts = rp[frontier + 1] - starts
    offs = np.repeat(starts - np.cumsum(counts) + counts, counts)
    return offs + np.arange(counts.sum())


def bfs_cpu(A, source: int, max_depth: int = 10**9) -> np.ndarray:
    """BFS levels: source = 1, neighbours = level + 1, unreached = 0
    (reference: test_bfs.hpp:12-60 SimpleReferenceBfs), one whole level at a
    time along the out-edges of the CSR."""
    rp, ci, _, n = _csr(A)
    rp = np.asarray(rp, np.int64)
    ci = np.asarray(ci, np.int64)
    path = np.zeros(n, dtype=np.float32)
    path[source] = 1
    frontier = np.array([source], dtype=np.int64)
    depth = 1
    while frontier.size and depth < max_depth:
        nbrs = ci[_out_edges(rp, frontier)]
        nbrs = np.unique(nbrs[path[nbrs] == 0])
        depth += 1
        path[nbrs] = depth
        frontier = nbrs
    return path


def sssp_cpu(A, source: int) -> np.ndarray:
    """Distances from `source`, float32, unreachable = FLT_MAX and
    dist[source] = 0 (reference: test_sssp.hpp:14-70 SimpleReferenceSssp):
    Bellman-Ford over frontiers, each round relaxing the out-edges of the
    vertices whose distance fell in the last one with float32 sums and
    np.minimum.at. With non-negative weights it gives the minimum over
    paths of the float32 sums, as Dijkstra does."""
    rp, ci, val, n = _csr(A)
    rp = np.asarray(rp, np.int64)
    ci = np.asarray(ci, np.int64)
    val = np.asarray(val, np.float32)
    dist = np.full(n, MAXF, dtype=np.float32)
    dist[source] = 0.0
    frontier = np.array([source], dtype=np.int64)
    while frontier.size:
        slots = _out_edges(rp, frontier)
        src = np.repeat(frontier, rp[frontier + 1] - rp[frontier])
        new = dist.copy()
        np.minimum.at(new, ci[slots], dist[src] + val[slots])
        frontier = np.flatnonzero(new < dist)
        dist = new
    return dist


def pr_cpu(A, alpha: float = 0.85, eps: float = 1e-6,
           max_niter: int = 100) -> np.ndarray:
    """PageRank on the raw adjacency, degree-normalised inside as
    SimpleReferencePr does (test_pr.hpp:14-80): p ← α·Aᵀ(p/outdeg) +
    (1-α)/n from p = 1/n, with outdeg the edge count (at least 1), until the
    squared-L2 residual is below eps. p is float32; each step sums the
    in-edge contributions in float64 (np.bincount) and rounds once."""
    rp, ci, _, n = _csr(A)
    rp = np.asarray(rp, np.int64)
    deg = np.diff(rp)
    src = np.repeat(np.arange(n), deg)
    dst = np.asarray(ci, np.int64)
    outdeg = np.maximum(deg, 1).astype(np.float32)
    p = np.full(n, 1.0 / n, dtype=np.float32)
    for _ in range(max_niter):
        contrib = alpha * p / outdeg
        nxt = (np.bincount(dst, weights=contrib[src], minlength=n)
               + (1.0 - alpha) / n).astype(np.float32)
        resid = float(((p - nxt) ** 2).sum())
        p = nxt
        if resid < eps:
            break
    return p


def cc_cpu(A) -> np.ndarray:
    """Component labels, the least vertex id of each (weakly) connected
    component (reference: test_cc.hpp SimpleReferenceCc): min-label
    propagation along both ends of every edge with pointer jumping, as
    bench.py's vectorised CC golden does, until nothing changes."""
    rp, ci, _, n = _csr(A)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(rp, np.int64)))
    cols = np.asarray(ci, np.int64)
    label = np.arange(n)
    while True:
        new = label.copy()
        np.minimum.at(new, rows, label[cols])
        np.minimum.at(new, cols, label[rows])
        new = np.minimum(new, new[new])
        if np.array_equal(new, label):
            return label
        label = new


def verify_cc(A, labels) -> bool:
    """Property check: the two ends of every edge share a label (reference:
    test_cc.hpp:58-95 SimpleVerifyCc)."""
    rp, ci, _, n = _csr(A)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(rp, np.int64)))
    labels = np.asarray(labels)
    return bool((labels[rows] == labels[np.asarray(ci, np.int64)]).all())


def tc_cpu(A, chunk: int = 1 << 24) -> int:
    """Σ over the stored (u, w) of |N(u) ∩ N(w)|, N from the host CSR with
    duplicate entries dropped (reference: test_tc.hpp SimpleReferenceTc):
    the triangle count of a lower-triangular L. Vectorised: for each edge
    the shorter of the two rows is looked up in the sorted int64 keys
    u·n + v of all entries with np.searchsorted, `chunk` lookups at a
    time."""
    rp, ci, _, n = _csr(A)
    rp = np.asarray(rp, np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    keys = np.unique(rows * n + np.asarray(ci[: rp[-1]], np.int64))
    if keys.size == 0:
        return 0
    u, w = keys // n, keys % n
    rp = np.zeros(n + 1, np.int64)
    rp[1:] = np.cumsum(np.bincount(u, minlength=n))
    deg = np.diff(rp)
    walk_w = deg[w] < deg[u]           # walk the shorter row
    walked = np.where(walk_w, w, u)
    other = np.where(walk_w, u, w)
    lens = deg[walked]
    ends = np.cumsum(lens)
    count, s = 0, 0
    while s < len(keys):
        base = ends[s - 1] if s else 0
        t = max(int(np.searchsorted(ends, base + chunk, side="right")), s + 1)
        seg = lens[s:t]
        lane = np.arange(int(ends[t - 1] - base), dtype=np.int64)
        e = np.repeat(np.arange(s, t), seg)
        pos = rp[walked[e]] + lane - (ends[e] - seg[e - s] - base)
        q = other[e] * n + w[pos]
        hit = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        count += int(np.count_nonzero(keys[hit] == q))
        s = t
    return count


def mis_cpu(A, seed: int = 0) -> np.ndarray:
    """Greedy maximal independent set over a seeded random vertex order;
    1 = in the set (reference: test_mis.hpp SimpleReferenceMis)."""
    rp, ci, _, n = _csr(A)
    state = np.zeros(n, dtype=np.int32)  # 0 unknown, 1 in set, -1 removed
    for u in np.random.RandomState(seed).permutation(n):
        if state[u] == 0:
            state[u] = 1
            nbrs = ci[rp[u]:rp[u + 1]]
            state[nbrs] = np.where(state[nbrs] == 1, 1, -1)
    return (state == 1).astype(np.int32)


def _edges_without_loops(A) -> tuple:
    """(rows, cols, n) of the CSR's edges, self-loops left out."""
    rp, ci, _, n = _csr(A)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(rp, np.int64)))
    cols = np.asarray(ci, np.int64)
    keep = rows != cols
    return rows[keep], cols[keep], n


def verify_mis(A, in_set) -> bool:
    """Independence and maximality (reference: test_mis.hpp
    SimpleVerifyMis): no edge joins two members, and every vertex outside
    the set has a neighbour in it, so an isolated vertex is a member."""
    rows, cols, n = _edges_without_loops(A)
    s = np.asarray(in_set) != 0
    if (s[rows] & s[cols]).any():
        return False
    covered = np.zeros(n, dtype=bool)
    covered[rows[s[cols]]] = True
    return bool((s | covered).all())


def gc_cpu(A, seed: int = 0) -> np.ndarray:
    """Greedy colouring over a seeded random vertex order, colours >= 1
    (reference: test_gc.hpp)."""
    rp, ci, _, n = _csr(A)
    colors = np.zeros(n, dtype=np.int32)
    for u in np.random.RandomState(seed).permutation(n):
        used = set(colors[ci[rp[u]:rp[u + 1]]].tolist())
        c = 1
        while c in used:
            c += 1
        colors[u] = c
    return colors


def verify_gc(A, colors) -> bool:
    """A proper colouring: every vertex coloured (>= 1) and no edge joins
    two vertices of one colour (reference: test_gc.hpp SimpleVerifyGc)."""
    rows, cols, _ = _edges_without_loops(A)
    colors = np.asarray(colors)
    return bool((colors > 0).all()
                and not (colors[rows] == colors[cols]).any())


def lgc_cpu(A, source: int, alpha: float = 0.15, eps: float = 1e-6,
            max_niter: int = 200) -> np.ndarray:
    """Andersen-Chung-Lang PPR push, the GraphBLAS formulation of
    lgc.hpp:14-163 (reference: test_lgc.hpp SimpleReferenceLgc):
      while ∃ frontier f = {r(v) ≥ d(v)·eps, d(v) > 0}:
        p += α·r.*f ; r_f = (1-α)/2 · r.*f ; r = r - r.*f + Aᵀ(r_f / d)
    in float32. Vectorised: each iteration's push adds the frontier's
    contributions along their out-edges in one float64 bincount, where the
    JAX golden adds them one vertex at a time in float32."""
    rp, ci, _, n = _csr(A)
    rp = np.asarray(rp, np.int64)
    ci = np.asarray(ci, np.int64)
    deg = np.diff(rp).astype(np.float32)
    p = np.zeros(n, dtype=np.float32)
    r = np.zeros(n, dtype=np.float32)
    r[source] = 1.0
    for _ in range(max_niter):
        f = (r >= deg * eps) & (deg > 0)
        if not f.any():
            break
        p[f] += alpha * r[f]
        spread = np.where(f, (1.0 - alpha) / 2.0 * r, 0.0).astype(np.float32)
        r = np.where(f, spread, r)
        contrib = np.where(f, spread / np.maximum(deg, 1), 0.0).astype(
            np.float32)
        frontier = np.flatnonzero(f)
        edges = _out_edges(rp, frontier)
        src = np.repeat(frontier, rp[frontier + 1] - rp[frontier])
        push = np.bincount(ci[edges], weights=contrib[src].astype(
            np.float64), minlength=n).astype(np.float32)
        r = r + push
    return p
