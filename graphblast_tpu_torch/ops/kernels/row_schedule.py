"""The row schedule: how the pull kernels that fold each row of a CSR into
one value spread a sparsity structure over the card. The value pull (K2/K3),
the monoid pull (K4) and the bitmap pull (K1) read rows through it, with the
walk written once in csrc/row_schedule.cuh.

Rows are stably sorted into N_BINS bins by length: rows of more than
LONG_ROW edges, each one thread-block cluster of CLUSTER blocks with a chunk
of the row each; rows of up to LONG_ROW edges, a warp each; rows of at most
32, 16, 8 and 4 edges, a group of that many lanes each. The schedule depends
only on the row pointers, so one schedule serves every plan over one pull
orientation of a Matrix, whatever its values or semiring: `schedule_for`
builds it once and caches it in the Matrix's plans.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...types import INDEX_DTYPE

# T, tuned on an H100 at RMAT scale 18 by a sweep over 2048 .. 16384
# (PERF.md): a row of more edges is cut into CLUSTER chunks, one block's
# work each, the blocks of one thread-block cluster
LONG_ROW = 8192
CLUSTER = 8     # kCluster of csrc/row_schedule.cuh
# bins, in the order of the schedule: long rows, medium rows (one warp a
# row), then rows of at most 32, 16, 8 and 4 edges (a group of that many
# lanes a row); the kernel's rows a 256-thread block takes in bins 1-5
N_BINS = 6
ROWS_A_BLOCK = (None, 8, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class RowSchedule:
    """How a kernel spreads one sparsity structure over the card, built
    by `build_schedule` on ptr's device. `perm` (int32, n_out) is the rows
    stably sorted by bin, bin b at perm[bin_begin[b]:bin_begin[b + 1]];
    the k-th long row (bin 0) is cut into CLUSTER chunks of about equal
    length, chunk j from edge chunk_beg[CLUSTER * k + j] to the next
    chunk's start (the row's end for the last). Blocks block_begin[b] ..
    block_begin[b+1] - 1 serve bin b, one chunk or ROWS_A_BLOCK[b] rows
    each. Nothing in it changes after it is built, and the kernels keep no
    scratch of their own."""

    perm: torch.Tensor
    bin_begin: tuple
    chunk_beg: torch.Tensor
    block_begin: tuple

    def __post_init__(self):
        meta = (ctypes.c_int * (2 * N_BINS + 2))(
            *self.block_begin, *self.bin_begin)
        # the kernels' arguments after y, as a launch passes them
        args = (self.perm.data_ptr(), self.chunk_beg.data_ptr(),
                ctypes.addressof(meta))
        object.__setattr__(self, "_meta", meta)
        object.__setattr__(self, "args", args)

    @property
    def bin_rows(self) -> tuple:
        return tuple(self.bin_begin[b + 1] - self.bin_begin[b]
                     for b in range(N_BINS))

    @property
    def n_chunks(self) -> int:
        return self.chunk_beg.shape[0]

    @property
    def blocks(self) -> int:
        return self.block_begin[-1]


def build_schedule(ptr: torch.Tensor) -> RowSchedule:
    """The row schedule of a CSR's row pointers (int32, n_out + 1), with
    torch ops on ptr's device and one read of six sizes to the host. A
    row of L edges goes to bin 0 when L > LONG_ROW, bin 1 when 32 < L <=
    LONG_ROW, else to bin 2, 3, 4 or 5 when L is at most 32, 16, 8 or 4."""
    dev = ptr.device
    length = (ptr[1:] - ptr[:-1]).long()
    bins = (N_BINS - 1) - sum((length > t).long()
                              for t in (4, 8, 16, 32, LONG_ROW))
    perm = torch.argsort(bins, stable=True)
    rows = torch.bincount(bins, minlength=N_BINS).tolist()
    long_rows = perm[:rows[0]]
    beg = ptr[long_rows].long()
    n = length[long_rows]
    step = (n + CLUSTER - 1) // CLUSTER
    chunk_beg = beg[:, None] + torch.minimum(
        torch.arange(CLUSTER, device=dev) * step[:, None], n[:, None])
    blocks = [CLUSTER * rows[0]] + [-(-rows[b] // ROWS_A_BLOCK[b])
                                    for b in range(1, N_BINS)]
    return RowSchedule(
        perm=perm.to(INDEX_DTYPE),
        bin_begin=tuple(np.cumsum([0] + rows).tolist()),
        chunk_beg=chunk_beg.reshape(-1).to(INDEX_DTYPE),
        block_begin=tuple(np.cumsum([0] + blocks).tolist()))


def plan_schedule(ptr: torch.Tensor,
                  sched: Optional[RowSchedule]) -> Optional[RowSchedule]:
    """The schedule a plan over ptr (n_out + 1 row pointers) keeps:
    `sched`, which must order n_out rows on ptr's device, or, when it is
    None, a new one for a plan on the card (a CPU plan runs the plain
    versions, which need none)."""
    if sched is None:
        return build_schedule(ptr) if ptr.is_cuda else None
    n_out = ptr.shape[0] - 1
    if sched.perm.shape[0] != n_out or sched.perm.device != ptr.device:
        raise ValueError(f"the schedule orders {sched.perm.shape[0]} rows "
                         f"on {sched.perm.device}, the plan has {n_out} on "
                         f"{ptr.device}")
    return sched


def schedule_for(A, transpose: bool = False) -> Optional[RowSchedule]:
    """The RowSchedule of one pull orientation of Matrix `A` (the CSR, or
    the CSC for transpose=True), built on its device at the first call and
    cached in A._plans under "csr/schedule" / "csc/schedule": every plan
    of the orientation (value, monoid, bitmap) shares it. None when A
    lacks that orientation."""
    ptr = A.pull_csr(transpose)[2]
    if ptr is None:
        return None
    key = ("csc" if transpose else "csr") + "/schedule"
    if key not in A._plans:
        A._plans[key] = build_schedule(ptr)
    return A._plans[key]


def launch_args(plan) -> tuple:
    """The schedule's kernel arguments of a plan on the card (perm,
    chunk_beg, meta); raises when the plan has no schedule."""
    if plan.sched is None:
        raise ValueError("a plan on the card needs its RowSchedule (its "
                         "build_plan* or plan_for* gives it one)")
    return plan.sched.args
