"""K1, the bitmap pull: y[i] = number of pull-orientation edges (i, j) whose
bit j is set in the packed frontier. (y > 0) is the structure-only
LogicalOrAnd pull of BFS. A plan with a mask (`BitmapPlan.mask`, float32)
takes the masked entry, which gives that pull under the mask directly:
y[i] = 1 where the mask passes at i and some edge (i, j) has bit j set,
else 0.

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

The masked entry follows the reference GPU's masked or-pull
(spmvDenseMaskedOrKernel<scmp, earlyexit>, kernels/spmv.hpp:10-59 of the
reference): each row reads its mask entry first, a closed row reads
nothing more (BFS's visited rows), and an open row stops at its first
frontier id, to the grain of the walk. Its bound is the least bytes of a
masked or-pull (gbench/roofline.py `orpull_least_bytes`): the ids of the
open rows up to their first frontier id, their row pointers, and n/8 B
for each of three bitmaps.

`spmv_bitmap_pull` launches the kernel for CUDA tensors and counts each
launch in `spmv_bitmap_pull.launches`, and each masked one in
`spmv_bitmap_pull.masked_launches` too; for CPU tensors it runs the plain
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

_SIGNATURES = {
    "gb_bitmap_pull": ([ctypes.c_void_p] * 8, ctypes.c_int),
    "gb_bitmap_pull_masked": ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                              + [ctypes.c_void_p] * 5, ctypes.c_int),
    "gb_error_string": ([ctypes.c_int], ctypes.c_char_p)}
_LAUNCH = _build.launcher("bitmap_pull", _SIGNATURES, "gb_bitmap_pull",
                          "gb_error_string")
_LAUNCH_MASKED = _build.launcher("bitmap_pull", _SIGNATURES,
                                 "gb_bitmap_pull_masked", "gb_error_string")


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
    RowSchedule, which a launch on the card needs. `mask`, a float32
    (n_out,) tensor, makes a pull over the plan the masked one: it passes
    where it is not 0, or, with `mask_scmp`, where it is 0. A caller gives
    one call's mask to a copy (`dataclasses.replace`), never to the
    cached plan."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    sched: Optional[RowSchedule] = None
    mask: Optional[torch.Tensor] = None
    mask_scmp: bool = False


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
    row with index_add_. int32 counts; with the plan's mask, 0/1 from the
    open rows' edges alone (a closed row's are never expanded)."""
    ptr = plan.ptr.long()
    if plan.mask is not None:
        return _masked_plain(plan, words, ptr)
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    cols = plan.ind[:m]
    bit = (words[(cols >> 5).long()] >> (cols & 31)) & 1
    y = torch.zeros(plan.n_out, dtype=torch.int32, device=ptr.device)
    return y.index_add_(0, rows, bit.to(torch.int32))


def _masked_plain(plan: BitmapPlan, words: torch.Tensor,
                  ptr: torch.Tensor) -> torch.Tensor:
    rows = torch.nonzero((plan.mask != 0) != plan.mask_scmp).flatten()
    length = ptr[rows + 1] - ptr[rows]
    m = int(length.sum())
    edge_rows = torch.repeat_interleave(rows, length, output_size=m)
    # an edge's position: its row's start, plus its rank in the row
    first = torch.cumsum(length, 0) - length
    pos = (ptr[edge_rows] + torch.arange(m, device=ptr.device)
           - torch.repeat_interleave(first, length, output_size=m))
    cols = plan.ind[pos]
    bit = (words[(cols >> 5).long()] >> (cols & 31)) & 1
    hits = torch.zeros(plan.n_out, dtype=torch.int32, device=ptr.device)
    hits.index_add_(0, edge_rows, bit.to(torch.int32))
    return (hits > 0).to(torch.int32)


def _check(plan: BitmapPlan, words: torch.Tensor):
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be a 1-D int32 tensor")
    if words.shape[0] < (plan.n_in + 31) // 32:
        raise ValueError(f"{words.shape[0]} words cannot hold {plan.n_in} "
                         "frontier bits")
    if words.device != plan.ptr.device:
        raise ValueError(f"words on {words.device}, plan on "
                         f"{plan.ptr.device}")
    mask = plan.mask
    if mask is not None:
        if mask.dtype != torch.float32 or mask.dim() != 1:
            raise TypeError("a bitmap plan's mask must be a 1-D float32 "
                            "tensor")
        if mask.shape[0] != plan.n_out or mask.device != plan.ptr.device:
            raise ValueError(f"a mask of {mask.shape[0]} entries on "
                             f"{mask.device}, the plan has {plan.n_out} "
                             f"rows on {plan.ptr.device}")


def spmv_bitmap_pull(plan: BitmapPlan, words: torch.Tensor) -> torch.Tensor:
    """y[i] = count of plan edges (i, j) with bit j set in `words` (int32,
    (n_out,)); over a plan with a mask, 1 where the mask passes at i and
    that count is not 0, else 0. CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream, or raise (a plan with
    no schedule too)."""
    _check(plan, words)
    if words.device.type == "cpu":
        return spmv_bitmap_pull_plain(plan, words)
    if words.device.type != "cuda":
        raise ValueError(f"no bitmap pull for device {words.device}")
    words = words.contiguous()
    y = torch.empty(plan.n_out, dtype=torch.int32, device=words.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    if plan.mask is None:
        _LAUNCH(words.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
                words.data_ptr(), y.data_ptr(), *launch_args(plan))
    else:
        mask = plan.mask.contiguous()
        _LAUNCH_MASKED(words.get_device(), plan.ptr.data_ptr(),
                       plan.ind.data_ptr(), words.data_ptr(),
                       mask.data_ptr(), int(plan.mask_scmp), y.data_ptr(),
                       *launch_args(plan))
        spmv_bitmap_pull.masked_launches += 1
    spmv_bitmap_pull.launches += 1
    return y


spmv_bitmap_pull.launches = 0
spmv_bitmap_pull.masked_launches = 0
