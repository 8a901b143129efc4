"""K2 and K3, the value pull: y[i] = Σ val[e]·x[ind[e]] over the edges of
row i of the pull orientation, fp32 products and fp32 accumulation (the
Plus-Times SpMV of PageRank). A unit-valued plan (`unit_vals`) sums x over
the row, so on a 0/1 frontier (y > 0) is the LogicalOrAnd pull.

Replaces graphblast_tpu/ops/pallas/bilinear.py:_kernel / _kernel_packed
(K2, run by spmv_bilinear on plans from build_plan / plan_for) and
_kernel_f32_dma (K3, run by spmv_bilinear_dma on plans from
build_plan_f32dma). The two TPU layouts exist because x and y must fit VMEM
below a size gate (bilinear_available) and are windowed by DMA above it;
their tiles, bit-packed local ids, lane sweeps, one-hot matrix-unit scatter,
hi/lo split and pack=K columns all work around VMEM and the matrix unit.
On Hopper the plan is the pull orientation's CSR (CSC for vxm) with its
values and a row schedule (row_schedule.py: rows binned by length, long
rows cut into chunks, a thread-block cluster a row), and one kernel
(csrc/value_pull.cu) serves every size. It is memory-bound: 8·nnz +
4·(n_out + 1) + 4·n_in + 4·n_out bytes per call, 64.0 MB at RMAT scale 18,
19.1 µs at the H100's 3.35 TB/s.

`spmv_value_pull` launches the kernel for CUDA tensors and counts each
launch in `spmv_value_pull.launches`; for CPU tensors it runs the plain
PyTorch version, `spmv_value_pull_plain`, which the tests and the chip check
compare the kernel with.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...types import INDEX_DTYPE
from . import _build
from .row_schedule import (RowSchedule, launch_args, plan_schedule,
                           schedule_for)

_LAUNCH = _build.launcher(
    "value_pull",
    {"gb_value_pull": ([ctypes.c_void_p] * 9, ctypes.c_int),
     "gb_value_pull_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_value_pull", "gb_value_pull_error_string")


@dataclasses.dataclass(frozen=True)
class ValuePlan:
    """The pull orientation's CSR on the device: ptr (n_out+1,) int32, ind
    int32 with at least ptr[n_out] entries, all < n_in, and val float32 of
    the same reach, or None when every edge has the value 1 (`unit_vals`);
    and its RowSchedule, which a launch on the card needs (`build_plan`
    gives every plan on the card one, `plan_for` every plan the
    orientation's)."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: Optional[torch.Tensor]
    sched: Optional[RowSchedule] = None

    @property
    def unit_vals(self) -> bool:
        return self.val is None


def check_csr(ptr: torch.Tensor, ind: torch.Tensor,
              val: Optional[torch.Tensor], n_out: int, n_in: int) -> tuple:
    """Check a pull-orientation CSR, which the value and monoid kernels
    trust: int32 ptr (n_out+1,) non-decreasing from 0, ind with at least
    ptr[n_out] entries, all < n_in, and val (None: all ones) of the same
    reach. Returns (ptr, ind, val) contiguous, val as float32."""
    if ptr.dtype != INDEX_DTYPE or ind.dtype != INDEX_DTYPE:
        raise TypeError("plan index arrays must be int32")
    if ptr.device != ind.device or ptr.dim() != 1 or ind.dim() != 1:
        raise ValueError("ptr and ind must be 1-D tensors on one device")
    if ptr.shape[0] != n_out + 1:
        raise ValueError(f"ptr has {ptr.shape[0]} entries, want {n_out + 1}")
    m = int(ptr[-1])
    if m > ind.shape[0] or int(ptr[0]) != 0:
        raise ValueError("ptr does not index into ind")
    if n_out and not bool((ptr[1:] >= ptr[:-1]).all()):
        raise ValueError("ptr is not non-decreasing")
    if m and not 0 <= int(ind[:m].min()) <= int(ind[:m].max()) < n_in:
        raise ValueError(f"column ids outside [0, {n_in})")
    if val is not None:
        if val.dim() != 1 or val.shape[0] < m or val.device != ptr.device:
            raise ValueError(f"val must be 1-D on {ptr.device} with at "
                             f"least {m} entries")
        val = val.to(torch.float32).contiguous()
    return ptr.contiguous(), ind.contiguous(), val


def build_plan(ptr: torch.Tensor, ind: torch.Tensor,
               val: Optional[torch.Tensor], n_out: int, n_in: int,
               sched: Optional[RowSchedule] = None) -> ValuePlan:
    """Check a CSR and wrap it as a plan (the kernel trusts these bounds).
    `val=None` means all ones; other values are kept as float32. A plan on
    the card gets `sched`, which must be ptr's schedule, or a new one."""
    ptr, ind, val = check_csr(ptr, ind, val, n_out, n_in)
    return ValuePlan(n_out, n_in, ptr, ind, val, plan_schedule(ptr, sched))


def plan_for(A, transpose: bool = False,
             host_val: Optional[np.ndarray] = None,
             ones: bool = False) -> Optional[ValuePlan]:
    """Plan for one pull orientation of Matrix `A`: the CSR for the mxv pull
    (y = A·x), the CSC for the vxm pull (transpose=True, y = Aᵀ·x). Cached
    in A._plans under "csr"/"csc" (+ "/ones"); None when A lacks that
    orientation. `host_val` (NumPy, in the orientation's edge order)
    replaces the stored values, as PageRank's α/outdegree scaling does, and
    such a plan is never cached. `ones=True` gives a unit-valued plan.
    Every plan of an orientation shares its RowSchedule (`schedule_for`),
    so a host_val plan builds none."""
    n_out, n_in, ptr, ind, val = A.pull_csr(transpose)
    if ptr is None:
        return None
    key = ("csc" if transpose else "csr") + ("/ones" if ones else "")
    if host_val is None and key in A._plans:
        return A._plans[key]
    if ones:
        val = None
    elif host_val is not None:
        val = torch.from_numpy(np.ascontiguousarray(host_val)).to(ptr.device)
    plan = build_plan(ptr, ind, val, n_out, n_in,
                      schedule_for(A, transpose))
    if host_val is None:
        A._plans[key] = plan
    return plan


def spmv_value_pull_plain(plan: ValuePlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: expand row ids, index_add_ the float64
    products per row, cast to float32."""
    ptr = plan.ptr.long()
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    prod = x[plan.ind[:m].long()].double()
    if plan.val is not None:
        prod = prod * plan.val[:m].double()
    y = torch.zeros(plan.n_out, dtype=torch.float64, device=ptr.device)
    return y.index_add_(0, rows, prod).to(torch.float32)


def check_x(plan, x: torch.Tensor):
    """x as a kernel over `plan` takes it: contiguous 1-D float32 of
    length plan.n_in, on the plan's device."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError("x must be a 1-D float32 tensor")
    if x.shape[0] != plan.n_in:
        raise ValueError(f"x has {x.shape[0]} entries, the plan reads "
                         f"{plan.n_in}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.ptr.device:
        raise ValueError(f"x on {x.device}, plan on {plan.ptr.device}")


def spmv_value_pull(plan: ValuePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A·x over Plus-Times for the plan's orientation (float32,
    (n_out,)). CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream, or raise (a plan with no schedule too)."""
    check_x(plan, x)
    if x.device.type == "cpu":
        return spmv_value_pull_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"no value pull for device {x.device}")
    y = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    _LAUNCH(x.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
            None if plan.val is None else plan.val.data_ptr(), x.data_ptr(),
            y.data_ptr(), *launch_args(plan))
    spmv_value_pull.launches += 1
    return y


spmv_value_pull.launches = 0
