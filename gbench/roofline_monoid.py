"""The least work of K4, the monoid pull, whose roofline share the SSSP
cell reports: beside `roofline.py`, on its peaks."""
from __future__ import annotations

from gbench.roofline import PEAKS, least_seconds


def monoid_pull_least_bytes(n_out: int, n_in: int, nnz: int) -> int:
    """Bytes of one Minimum-Plus pull y = A x over a CSR of nnz stored
    float32 weights: a 4 B column id and a 4 B weight an edge, n_out + 1
    row pointers of 4 B, x read once and y written once at 4 B a vertex."""
    return 8 * nnz + 4 * (n_out + 1) + 4 * n_in + 4 * n_out


def monoid_pull_least_s(n_out: int, n_in: int, nnz: int,
                        peaks: dict = PEAKS["NVIDIA H100 80GB HBM3"]) -> float:
    """The least seconds of one such pull: its bytes at the peak memory
    rate (a min and an add an edge lie far under the float32 peak)."""
    return least_seconds(peaks, monoid_pull_least_bytes(n_out, n_in, nnz))
