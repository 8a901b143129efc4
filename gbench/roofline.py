"""Peaks of the card and the least work of the kernels whose roofline share
the benchmark reports, counted from the benchmark's own graph arrays.

A share is the least time the card could take for the work, the larger of
bytes over the peak memory rate and operations over the peak rate, divided
by the kernel's device time. Each input byte counts once and each output
byte once, and where the work depends on the data, what these inputs need.
"""
from __future__ import annotations

import torch

from gbench.graphs import Graph, chunks

# NVIDIA's H100 data sheet (SXM part, dense rates): HBM3 at 3.35 TB/s,
# 67 TFLOP/s in float32 outside the tensor cores; rates at the full 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12},
}


def peaks_of(kind: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)


def orpull_least_bytes(g: Graph, level: torch.Tensor, it: int) -> int:
    """Bytes the masked or-pull of BFS iteration `it` needs, given the
    final BFS levels (int, 0 unreached): the frontier is level == it, the
    visited set 1 <= level <= it, and the pull finds each open (unvisited)
    row's first neighbour in the frontier. It reads 4 B a column id of each
    open row up to and including its first id in the frontier (all of the
    row where none is), each row pointer that bounds an open row once (4
    B), and the frontier and visited bitmaps, and writes the new frontier's
    bitmap (n / 8 B each)."""
    n = g.n
    level = level.to(g.rows.device)
    opened = (level == 0) | (level > it)
    frontier = level == it
    first = g.deg.clone()       # a row's first frontier id, by position
    for s, e in chunks(g.m):
        r = g.rows[s:e]
        hit = frontier.index_select(0, g.cols[s:e])
        hit &= opened.index_select(0, r)
        rh = r[hit].long()
        pos = torch.arange(s, e, device=r.device)[hit] - g.ptr[rh]
        first.scatter_reduce_(0, rh, pos, reduce="amin")
    scanned = torch.where(first < g.deg, first + 1, g.deg)
    id_bytes = 4 * int(scanned[opened].sum())
    bounds = torch.zeros(n + 1, dtype=torch.bool, device=level.device)
    bounds[:n] |= opened
    bounds[1:] |= opened
    ptr_bytes = 4 * int(bounds.sum())
    return id_bytes + ptr_bytes + 3 * ((n + 7) // 8)


def value_pull_least(n_out: int, n_in: int, nnz: int) -> tuple:
    """(bytes, flops) of one Plus-Times pull y = A x over a CSR of nnz
    stored float32 values: a 4 B id and a 4 B value an edge, n_out + 1 row
    pointers of 4 B, x read once and y written once at 4 B an entry; a
    multiply and an add an edge."""
    return 8 * nnz + 4 * (n_out + 1) + 4 * n_in + 4 * n_out, 2 * nnz


def least_seconds(peaks: dict, nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / peaks["bytes_per_s"],
               flops / peaks["fp32_flop_per_s"])
