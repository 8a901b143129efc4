"""Per-iteration communication accounting for the distributed algorithms
(counterpart of graphblast_tpu/parallel/accounting.py; its formulas,
copied): the bytes each rank moves over the links, computed from the
partition's shapes, beside the bytes its local work reads and writes,
cross-checked against the sparse push's owner bucketing in the tests.

Every formula is per RANK per ITERATION, in bytes, for a P-way 1D row
partition (parallel/partition.py). Collective cost model (ring algorithms
over the ranks, the standard all-gather / reduce-scatter decomposition):

  all_gather(n_pad · b bytes sharded)  → each rank RECEIVES
      (P-1)/P · n_pad · b  over P-1 hops
  psum_scatter (reduce-scatter)        → the same volume
  all_to_all (P blocks of pair_cap)    → sends and receives
      (P-1) · pair_cap · b
  ppermute (a ring stage's send to the right-hand neighbour,
      batch_isend_irecv here)          → the block's size a stage
  the all-reduce of a scalar           → 4 bytes · 2 (negligible)

The rows keep the JAX package's names for the collectives, so a row here
equals its row there for the same inputs; torch.distributed's are
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
batch_isend_irecv.

`report`'s rates are arguments. Their defaults are datasheet figures for
the card the port runs on, not measurements: an H100 80GB HBM3 SXM at
700 W, HBM3 at 3,350 GB/s (the rate PERF.md's bounds use) and NVLink 4 at
450 GB/s a direction (900 GB/s both ways), with PCIe Gen5 x16 at 64 GB/s
a direction as the sensitivity column, for cards joined without NVLink.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F32 = 4
I32 = 4

# datasheet figures, GB/s: H100 80GB HBM3 SXM memory; NVLink 4 and PCIe
# Gen5 x16, each one direction
H100_HBM_GBS = 3350.0
H100_NVLINK_GBS = 450.0
PCIE5_X16_GBS = 64.0


@dataclass
class CommRow:
    algorithm: str
    exchange: str                 # collective(s) used per iteration
    comm_bytes: float             # per rank per iteration
    compute_bytes: float          # local memory traffic per rank per iteration
    note: str = ""

    def efficiency(self, hbm_gbs: float, link_gbs: float) -> float:
        """Projected compute fraction t_comp / (t_comp + t_comm) assuming no
        overlap (a lower bound; the ring-staged variants overlap)."""
        t_comp = self.compute_bytes / (hbm_gbs * 1e9)
        t_comm = self.comm_bytes / (link_gbs * 1e9)
        return t_comp / (t_comp + t_comm) if (t_comp + t_comm) else 1.0


def _spmv_local_bytes(nnz: int, P: int, n_pad: int) -> float:
    """Local pull SpMV memory traffic: the edge stream (ind + val), x read,
    y written (12 B an edge plus the vectors)."""
    return (nnz / P) * (I32 + F32) + n_pad * F32 + (n_pad / P) * F32


def pull_allgather(nnz: int, P: int, n_pad: int, algorithm="bfs/pr pull",
                   vec_bytes: int = F32) -> CommRow:
    comm = (P - 1) / P * n_pad * vec_bytes
    return CommRow(algorithm, "all_gather(x)", comm,
                   _spmv_local_bytes(nnz, P, n_pad))


def push_dense(nnz_frontier_edges: int, P: int, n_pad: int,
               algorithm="push (dense partial)") -> CommRow:
    """Owner-routing a whole (n_pad,) ⊕-partial by a reduce-scatter: O(n)
    whatever the frontier's size (the dense push the sparse exchange
    replaces)."""
    comm = (P - 1) / P * n_pad * F32
    compute = nnz_frontier_edges / P * (I32 + F32) + n_pad * F32
    return CommRow(algorithm, "psum_scatter(partial)", comm, compute)


def push_sparse(P: int, pair_cap: int, frontier_edges: int,
                algorithm="push (sparse exchange)") -> CommRow:
    """The owner-bucketed all-to-all of (id, value) pairs: a fixed buffer
    of (P-1)·pair_cap·8 B; the LIVE volume scales with the frontier."""
    comm = (P - 1) * pair_cap * (I32 + F32)
    compute = frontier_edges / P * (I32 + F32) * 3   # expand + sort passes
    return CommRow(algorithm, "all_to_all(P·pair_cap)", comm, compute,
                   note=f"live pairs ≤ buffer; frontier edges/P = "
                        f"{frontier_edges / P:.0f}")


def pr_ring(nnz: int, P: int, n_pad: int) -> CommRow:
    """Ring-scheduled PageRank: P-1 stages each send the (n_pad/P) block;
    the total equals the all-gather's, but each stage overlaps the local
    multiply."""
    comm = (P - 1) * (n_pad / P) * F32
    return CommRow("pr (ring)", "ppermute ×(P-1)", comm,
                   _spmv_local_bytes(nnz, P, n_pad),
                   note="stages overlap compute")


def pr_2d(nnz: int, Pr: int, Pc: int, n_pad: int) -> CommRow:
    """The 2D layout: a row exchange of x and a column combine of the
    partials, each O(n_pad/√P) a rank instead of O(n_pad)."""
    comm = ((Pc - 1) / Pc * (n_pad / Pr) * F32
            + (Pr - 1) / Pr * (n_pad / Pc) * F32)
    return CommRow("pr (2d SUMMA)", "all_gather(row) + psum_scatter(col)",
                   comm, _spmv_local_bytes(nnz, Pr * Pc, n_pad))


def tc_ring(nnz: int, P: int) -> CommRow:
    """Ring-staged TC: each of the P stages passes a CSR row block (ptr +
    ind + val) on."""
    comm = (P - 1) * (nnz / P) * (I32 + F32)
    return CommRow("tc (ring)", "ppermute(CSR block) ×(P-1)", comm,
                   nnz / P * (I32 + F32) * P,
                   note="block transfer overlaps stage compute")


def sparse_push_live_pairs(row_ptr: np.ndarray, col_ind: np.ndarray,
                           frontier: np.ndarray, P: int,
                           rows_per: int) -> np.ndarray:
    """Ground-truth pair counts: for each (source rank k, destination rank
    d) the number of expanded frontier edges from block k into block d,
    (P, P) int64. The tests and the chip check hold owner_buckets' counts
    to it."""
    row_ptr = np.asarray(row_ptr)
    col_ind = np.asarray(col_ind)
    counts = np.zeros((P, P), np.int64)
    for u in np.flatnonzero(frontier):
        k = u // rows_per
        dsts = col_ind[row_ptr[u]:row_ptr[u + 1]]
        own, c = np.unique(dsts // rows_per, return_counts=True)
        counts[k, own] += c
    return counts


def report(n: int, nnz: int, P: int, pair_cap: int, frontier_edges: int,
           hbm_gbs: float = H100_HBM_GBS, link_gbs: float = H100_NVLINK_GBS,
           link_cons_gbs: float = PCIE5_X16_GBS) -> str:
    """Markdown table of each algorithm's per-iteration link traffic and
    local memory traffic a rank, and the projected scaling efficiency
    t_comp / (t_comp + t_comm), which equals edges/s at P cards over P ×
    edges/s at one when the one-card run is memory-bound. The rates are
    GB/s; the defaults are the module docstring's datasheet figures
    (H100 HBM3; NVLink 4, and PCIe Gen5 x16 as the sensitivity column)."""
    n_pad = ((n + P * 8 - 1) // (P * 8)) * P * 8
    rows = [
        pull_allgather(nnz, P, n_pad),
        push_dense(frontier_edges, P, n_pad),
        push_sparse(P, pair_cap, frontier_edges),
        pr_ring(nnz, P, n_pad),
        pr_2d(nnz, int(np.sqrt(P)), P // int(np.sqrt(P)), n_pad),
        tc_ring(nnz, P),
    ]
    out = [f"| algorithm | exchange | link B/rank/iter | memory B/rank/iter "
           f"| eff @link {link_gbs:.0f} GB/s | eff @link {link_cons_gbs:.0f} "
           f"| note |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r.algorithm} | {r.exchange} | {r.comm_bytes:,.0f} "
                   f"| {r.compute_bytes:,.0f} "
                   f"| {100 * r.efficiency(hbm_gbs, link_gbs):.0f}% "
                   f"| {100 * r.efficiency(hbm_gbs, link_cons_gbs):.0f}% "
                   f"| {r.note} |")
    return "\n".join(out)
