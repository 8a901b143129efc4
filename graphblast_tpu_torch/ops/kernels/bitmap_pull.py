"""K1, the bitmap pull: y[i] = number of pull-orientation edges (i, j) whose
bit j is set in the packed frontier. (y > 0) is the structure-only
LogicalOrAnd pull of BFS.

Replaces graphblast_tpu/ops/pallas/bilinear.py:_bitmap_chunk_body (launched
by _kernel_bitmap_prefetch / _kernel_bitmap_dma via spmv_bilinear_bitmap,
plan from build_plan_bitmap / plan_for_bitmap) and the frontier packer
graphblast_tpu/ops/pallas/orpull.py:pack_bitmap.

The TPU plan's panels, windows and one-hot scatter work around VMEM and the
matrix unit; on Hopper the plan is the pull orientation's CSR (CSC for vxm)
with the orientation's row schedule (row_schedule.py, shared with the value
and monoid pulls), which the CUDA kernel (csrc/bitmap_pull.cu) reads rows
through. It is memory-bound: 4·(nnz + 2·n_out + ⌈n_in/32⌉) bytes per call,
32.6 MB at RMAT scale 18, 9.7 µs at the H100's 3.35 TB/s.

`spmv_bitmap_pull` launches the kernel for CUDA tensors and counts each
launch in `spmv_bitmap_pull.launches`; for CPU tensors it runs the plain
PyTorch version, `spmv_bitmap_pull_plain`, which the tests and the chip
check compare the kernel with.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ...types import round_up
from . import _build
from .row_schedule import (RowSchedule, launch_args, plan_schedule,
                           schedule_for)
from .value_pull import check_csr

_LAUNCH = _build.launcher(
    "bitmap_pull",
    {"gb_bitmap_pull": ([ctypes.c_void_p] * 8, ctypes.c_int),
     "gb_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_bitmap_pull", "gb_error_string")


def pack_bitmap(x_dense: torch.Tensor) -> torch.Tensor:
    """Pack (x != 0) into int32 words, bit c of the frontier at word c>>5,
    bit c&31 (little-endian, as the JAX package's orpull.pack_bitmap).
    Words with bit 31 set come out negative, as JAX's wrapped int32 sum."""
    n = x_dense.shape[0]
    n32 = round_up(max(n, 1), 32)
    bits = torch.zeros(n32, dtype=torch.int64, device=x_dense.device)
    bits[:n] = x_dense != 0
    shifts = torch.arange(32, dtype=torch.int64, device=x_dense.device)
    w = (bits.view(-1, 32) << shifts).sum(dim=1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BitmapPlan:
    """The pull orientation's CSR on the device: ptr (n_out+1,) int32, ind
    int32 with at least ptr[n_out] entries, all < n_in; and its
    RowSchedule, which a launch on the card needs."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    sched: Optional[RowSchedule] = None


def build_plan_bitmap(ptr: torch.Tensor, ind: torch.Tensor, n_out: int,
                      n_in: int,
                      sched: Optional[RowSchedule] = None) -> BitmapPlan:
    """Check a CSR (value_pull.check_csr; the kernel trusts these bounds)
    and wrap it as a plan. A plan on the card gets `sched`, which must be
    ptr's schedule, or a new one."""
    ptr, ind, _ = check_csr(ptr, ind, None, n_out, n_in)
    return BitmapPlan(n_out, n_in, ptr, ind, plan_schedule(ptr, sched))


def plan_for_bitmap(A, transpose: bool = False):
    """Cached BitmapPlan for struconly pulls of Matrix `A`: the CSR for the
    mxv pull, the CSC for the vxm pull (transpose=True), with the
    orientation's shared RowSchedule (`schedule_for`). None when A lacks
    that orientation."""
    n_out, n_in, ptr, ind, _ = A.pull_csr(transpose)
    if ptr is None:
        return None
    key = ("csc" if transpose else "csr") + "/bitmap"
    if key not in A._plans:
        A._plans[key] = build_plan_bitmap(ptr, ind, n_out, n_in,
                                          schedule_for(A, transpose))
    return A._plans[key]


def spmv_bitmap_pull_plain(plan: BitmapPlan,
                           words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: expand row ids, test each edge's bit, sum per
    row with index_add_. int32 counts."""
    ptr = plan.ptr.long()
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    cols = plan.ind[:m]
    bit = (words[(cols >> 5).long()] >> (cols & 31)) & 1
    y = torch.zeros(plan.n_out, dtype=torch.int32, device=ptr.device)
    return y.index_add_(0, rows, bit.to(torch.int32))


def _check(plan: BitmapPlan, words: torch.Tensor):
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be a 1-D int32 tensor")
    if words.shape[0] < (plan.n_in + 31) // 32:
        raise ValueError(f"{words.shape[0]} words cannot hold {plan.n_in} "
                         "frontier bits")
    if words.device != plan.ptr.device:
        raise ValueError(f"words on {words.device}, plan on "
                         f"{plan.ptr.device}")


def spmv_bitmap_pull(plan: BitmapPlan, words: torch.Tensor) -> torch.Tensor:
    """y[i] = count of plan edges (i, j) with bit j set in `words` (int32,
    (n_out,)). CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream, or raise (a plan with no schedule
    too)."""
    _check(plan, words)
    if words.device.type == "cpu":
        return spmv_bitmap_pull_plain(plan, words)
    if words.device.type != "cuda":
        raise ValueError(f"no bitmap pull for device {words.device}")
    words = words.contiguous()
    y = torch.empty(plan.n_out, dtype=torch.int32, device=words.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    _LAUNCH(words.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
            words.data_ptr(), y.data_ptr(), *launch_args(plan))
    spmv_bitmap_pull.launches += 1
    return y


spmv_bitmap_pull.launches = 0
