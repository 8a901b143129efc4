"""Shared algorithm-loop machinery: timers and CSV rows (counterpart of
graphblast_tpu/algorithms/common.py).

The reference prints `iter, succ/n, unvisited, push|pull, ms` per iteration
(bfs.hpp:42-60); stepped mode keeps that contract.
"""
from __future__ import annotations

import time

import torch

from ..descriptor import Descriptor
from ..matrix import Matrix
from ..ops.kernels.row_schedule import schedule_for
from ..types import Storage, round_up
from ..vector import Vector


def edge_cap_for(A: Matrix, desc: Descriptor) -> int:
    """Static push workspace bound = memusage · nnz_pad (reference:
    spmspv_inner.hpp:51-59, util.hpp:91-92 --memusage)."""
    cap = int(round_up(max(int(A.nnz_pad * min(desc.memusage, 1.0)), 128),
                       128))
    return min(cap, A.nnz_pad)


class TightTimer:
    """Reference GpuTimer analog (backend/cuda/util.hpp:92-120): host clock
    around the iteration, stopped after the device has finished the work
    on the tensors passed to stop()."""

    def __init__(self):
        self.total_ms = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *sync_on: torch.Tensor) -> float:
        for dev in {x.device for x in sync_on if x.is_cuda}:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - self._t0) * 1000.0
        self.total_ms += ms
        return ms


def print_iter_row(it, succ, n, unvisited, used_push, ms, timing: int):
    """`iter, succ/n, unvisited, push|pull, ms` (reference: bfs.hpp:54-60)."""
    if timing >= 1:
        mode = "push" if used_push else "pull"
        print(f"{it}, {succ}/{n}, {unvisited}, {mode}, {ms:.4f}")


def print_dirinfo(nv, n, used_push, prev_push, dirinfo: bool):
    """Direction-switch announcements (reference: vector.hpp:306-309,
    334-335). Stepped mode only."""
    if not dirinfo:
        return
    if prev_push is not None and bool(used_push) != bool(prev_push):
        conv = ("dense2sparse (pull→push)" if used_push
                else "sparse2dense (push→pull)")
        print(f"[dirinfo] {conv}")
    print(f"[dirinfo] frontier nnz/n = {nv}/{n} = {nv / max(n, 1):.4f} -> "
          f"{'push' if used_push else 'pull'}")


def dense_result(n: int, arr: torch.Tensor) -> Vector:
    return Vector(n, Storage.DENSE, dense=arr)


def csc_int_arrays(A: Matrix) -> tuple:
    """(ptr, ind, val as int32, the RowSchedule of ptr) of A's CSC, or of
    its CSR for a CSRONLY matrix (col_ptr None): the reference's
    forced-direction idiom for that format
    (backend/cuda/operations.hpp:131-140), the same on the symmetric graphs
    that MIS and colouring run on. The schedule is the orientation's cached
    one (`schedule_for`), which the min/max pull on the card reads. Callers
    cast once per call and pass the arrays to every round, as JAX's jit
    hoists the cast."""
    if A.col_ptr is None:
        return (A.row_ptr, A.col_ind, A.val.to(torch.int32),
                schedule_for(A, transpose=False))
    return (A.col_ptr, A.csc_row_ind, A.csc_val.to(torch.int32),
            schedule_for(A, transpose=True))
