"""NumPy golden references (counterpart of
graphblast_tpu/algorithms/reference.py; reference:
graphblas/algorithm/test_bfs.hpp, test_pr.hpp). They read host CSR
arrays only.
"""
from __future__ import annotations

import numpy as np


def _csr(A):
    """Accept a Matrix or a (row_ptr, col_ind, val, n) tuple."""
    if isinstance(A, tuple):
        return A
    ptr, ci, v = A.host_csr()
    return ptr, ci, v, A.nrows


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
        starts, ends = rp[frontier], rp[frontier + 1]
        counts = ends - starts
        # every out-edge slot of the frontier, as one flat index array
        offs = np.repeat(starts - np.cumsum(counts) + counts, counts)
        nbrs = ci[offs + np.arange(counts.sum())]
        nbrs = np.unique(nbrs[path[nbrs] == 0])
        depth += 1
        path[nbrs] = depth
        frontier = nbrs
    return path


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
