"""The PageRank reference: GraphBLAST's `gpr` (example/gpr.cu:82-98 and
algorithm/pr.hpp:15-94) worked out again from the benchmark's canonical
arrays, in float64, plain PyTorch on the graph's device.

The prep scales each stored edge (i, j) by alpha / outdegree(i); the loop
is p' = A_scaled^T p + (1 - alpha) / n from p = 1/n, err = ||p' - p||_2,
with it from 1 while err > eps and it <= max_niter; it stops after K
iterations. A program is compared with p_K alone, unless the float64 err
at that boundary lies within ROUNDING of eps, where a float32 loop may
stop an iteration before or after (`stops`). The sums run in index_add_'s
order, which float64 makes immaterial here.
"""
from __future__ import annotations

import torch

from gbench.graphs import Graph, chunks

# a float32 err within this share of eps may fall on either side of it:
# its sum of squares over 2^25 entries and the float32 iterates it comes
# from are off by far less
ROUNDING = 1e-3


def scale(g: Graph, alpha: float) -> torch.Tensor:
    """alpha / outdegree of each vertex, float64, 0 where it has no edge."""
    deg = g.deg.to(torch.float64)
    return torch.where(deg > 0, alpha / deg.clamp(min=1), 0.0)


def _step(g: Graph, w: torch.Tensor, p: torch.Tensor,
          base: float) -> torch.Tensor:
    """A_scaled^T p + base: each edge (row, col) adds w[row] p[row] to col."""
    x = w * p
    y = torch.zeros(g.n, dtype=p.dtype, device=p.device)
    for s, e in chunks(g.m):
        y.index_add_(0, g.cols[s:e].long(), x.index_select(0, g.rows[s:e]))
    return y + base


def iterates(g: Graph, alpha: float, eps: float, max_niter: int) -> tuple:
    """({k: the float64 iterate p_k} for k = K-1, K, K+1 around the stop K
    of the loop (no p_0), K, {k: the float64 err of iteration k} for k = 1
    .. K+1)."""
    w = scale(g, alpha)
    base = (1.0 - alpha) / g.n
    p = torch.full((g.n,), 1.0 / g.n, dtype=torch.float64,
                   device=g.rows.device)
    prev, it, err, errs = None, 1, 1.0, {}
    while err > eps and it <= max_niter:
        new = _step(g, w, p, base)
        err = float(torch.linalg.vector_norm(new - p))
        errs[it] = err
        prev, p, it = p, new, it + 1
    stop = it - 1
    after = _step(g, w, p, base)
    errs[stop + 1] = float(torch.linalg.vector_norm(after - p))
    its = {stop: p, stop + 1: after}
    if stop > 1:
        its[stop - 1] = prev
    return its, stop, errs


def stops(stop: int, errs: dict, eps: float) -> list:
    """The stops a float32 loop may make: K, and K - 1 or K + 1 only where
    the float64 err at that boundary lies within ROUNDING of eps."""
    out = [stop]
    if stop > 1 and errs[stop - 1] - eps <= ROUNDING * eps:
        out.append(stop - 1)
    if eps - errs[stop] <= ROUNDING * eps:
        out.append(stop + 1)
    return sorted(out)


def control(g: Graph, alpha: float, eps: float, max_niter: int) -> torch.Tensor:
    """The control: the same loop with p and the scaled edges rounded to
    bfloat16 (the step below the configuration's float32), the sums kept in
    float32; the result as float32. bfloat16 iterates may never settle
    under eps, so the caller caps max_niter at the reference's stop."""
    w = scale(g, alpha).to(torch.bfloat16).to(torch.float32)
    base = (1.0 - alpha) / g.n
    p = torch.full((g.n,), 1.0 / g.n, dtype=torch.float32,
                   device=g.rows.device)
    it, err = 1, 1.0
    while err > eps and it <= max_niter:
        x = (w * p).to(torch.bfloat16).to(torch.float32)
        y = torch.zeros(g.n, dtype=torch.float32, device=p.device)
        for s, e in chunks(g.m):
            y.index_add_(0, g.cols[s:e].long(), x.index_select(0, g.rows[s:e]))
        new = (y + base).to(torch.bfloat16).to(torch.float32)
        err = float(torch.linalg.vector_norm(new - p))
        p, it = new, it + 1
    return p


def rel_l1(p: torch.Tensor, ref: torch.Tensor) -> float:
    """sum |p - ref| / sum |ref|, in float64."""
    p = p.to(device=ref.device, dtype=torch.float64)
    return float((p - ref).abs().sum() / ref.abs().sum())
