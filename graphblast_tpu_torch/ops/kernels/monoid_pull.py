"""K4, the min/max monoid pull: y[i] = ident ⊕ (⊕ over the edges e of row i
of the pull orientation of clamp(val[e] ⊗ x[ind[e]], ±FLT_MAX)) in fp32, for
⊕ ∈ {min, max} and ⊗ ∈ {plus, multiplies, select-second}. Rows with no
edges keep the identity. SSSP pulls MinimumPlus over the CSC; CC pulls
MinimumSelectSecond over the CSR.

Replaces graphblast_tpu/ops/pallas/monopull.py:_mono_kernel (run by
spmv_monoid on plans from build_plan_monoid / plan_for_monoid). Its
(tile, row, chi)-sorted 4096-square tiles, window sweeps, run-scan and
one-hot matrix-unit select with a hi/lo bf16 split work around the TPU's
lack of a scatter; on Hopper the plan is the pull orientation's CSR with
the orientation's row schedule (row_schedule.py, shared with the value and
bitmap pulls), and one kernel (csrc/monoid_pull.cu) serves every size, with
no size gate (the JAX plan_for_monoid gives None above the VMEM gate).
Memory-bound: 8·nnz + 4·(n_out + 1) + 4·n_in + 4·n_out bytes per call,
4·nnz less for select-second, which reads no values: 64.0 MB and 33.6 MB
at RMAT scale 18, 19.1 µs and 10.0 µs at the H100's 3.35 TB/s.

Products are exact fp32, so the kernel equals `spmv_monoid_plain`; the JAX
TPU kernel selects arithmetic products through a hi/lo bf16 matmul (about
1e-5 relative), its CPU path is exact.

`spmv_monoid` launches the kernel for CUDA tensors and counts each launch
in `spmv_monoid.launches`; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from .row_schedule import (RowSchedule, launch_args, plan_schedule,
                           schedule_for)
from .value_pull import check_csr, check_x

FLT_MAX = float(np.finfo(np.float32).max)

_LAUNCH = _build.launcher(
    "monoid_pull",
    {"gb_monoid_pull": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
     "gb_monoid_pull_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_monoid_pull", "gb_monoid_pull_error_string")

# semiring name -> (⊕, ⊗), as monopull.py:413-418
SEMIRING_MAP = {
    "MinimumPlus": ("min", "plus"),
    "MinimumMultiplies": ("min", "mul"),
    "MinimumSelectSecond": ("min", "second"),
    "MaximumMultiplies": ("max", "mul"),
}
# the kernel's codes for ⊕ and ⊗ (csrc/monoid_pull.cu)
_ADD_CODE = {"min": 0, "max": 1}
_MUL_CODE = {"plus": 0, "mul": 1, "second": 2}


@dataclasses.dataclass(frozen=True)
class MonoidPlan:
    """The pull orientation's CSR on the device, as a ValuePlan holds it:
    ptr (n_out+1,) int32, ind int32 with at least ptr[n_out] entries, all
    < n_in, and val float32 of the same reach or None (all ones); and its
    RowSchedule, which a launch on the card needs. A type of its own, so
    that mxv_dual picks the monoid pull by the plan's type."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: Optional[torch.Tensor]
    sched: Optional[RowSchedule] = None


def build_plan_monoid(ptr: torch.Tensor, ind: torch.Tensor,
                      val: Optional[torch.Tensor], n_out: int, n_in: int,
                      sched: Optional[RowSchedule] = None) -> MonoidPlan:
    """Check a CSR (value_pull.check_csr) and wrap it as a plan. A plan on
    the card gets `sched`, which must be ptr's schedule, or a new one."""
    ptr, ind, val = check_csr(ptr, ind, val, n_out, n_in)
    return MonoidPlan(n_out, n_in, ptr, ind, val, plan_schedule(ptr, sched))


def plan_for_monoid(A, transpose: bool = False,
                    ones: bool = False) -> Optional[MonoidPlan]:
    """Plan for one pull orientation of Matrix `A`: the CSR for the mxv
    pull, the CSC for the vxm pull (transpose=True). Cached in A._plans
    under "csr/monoid" / "csc/monoid" (+ "/ones" for a unit-valued plan,
    which CC's select-second takes); None when A lacks that orientation.
    Every plan of an orientation shares its RowSchedule (`schedule_for`).
    """
    n_out, n_in, ptr, ind, val = A.pull_csr(transpose)
    if ptr is None:
        return None
    key = ("csc" if transpose else "csr") + "/monoid" + ("/ones" if ones
                                                          else "")
    if key not in A._plans:
        A._plans[key] = build_plan_monoid(ptr, ind, None if ones else val,
                                          n_out, n_in,
                                          schedule_for(A, transpose))
    return A._plans[key]


def monoid_supported(semiring) -> bool:
    return semiring.name in SEMIRING_MAP


def _ops(semiring) -> tuple:
    """(⊕, ⊗, identity as a float) of a semiring the kernel computes."""
    if not monoid_supported(semiring):
        raise ValueError(f"no monoid pull for {semiring.name}; it computes "
                         f"{sorted(SEMIRING_MAP)}")
    add, mul = SEMIRING_MAP[semiring.name]
    return add, mul, float(semiring.identity(torch.float32))


def spmv_monoid_plain(plan: MonoidPlan, x: torch.Tensor,
                      semiring) -> torch.Tensor:
    """Plain PyTorch version, in float32 and the kernel's order: gather x,
    ⊗, clamp to ±FLT_MAX, then scatter_reduce amin/amax into y filled with
    the identity."""
    add, mul, ident = _ops(semiring)
    ptr = plan.ptr.long()
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    p = x[plan.ind[:m].long()]
    if mul != "second":
        a = (plan.val[:m] if plan.val is not None
             else torch.ones_like(p))
        p = a + p if mul == "plus" else a * p
    p = p.clamp(-FLT_MAX, FLT_MAX)
    y = torch.full((plan.n_out,), ident, dtype=torch.float32,
                   device=ptr.device)
    return y.scatter_reduce_(0, rows, p, "a" + add, include_self=True)


def spmv_monoid(plan: MonoidPlan, x: torch.Tensor, semiring) -> torch.Tensor:
    """The monoid pull of `semiring` (a SEMIRING_MAP entry) for the plan's
    orientation (float32, (n_out,)). CPU tensors run the plain version;
    CUDA tensors launch the kernel on the current stream, or raise (a plan
    with no schedule too)."""
    add, mul, ident = _ops(semiring)
    check_x(plan, x)
    if x.device.type == "cpu":
        return spmv_monoid_plain(plan, x, semiring)
    if x.device.type != "cuda":
        raise ValueError(f"no monoid pull for device {x.device}")
    y = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    _LAUNCH(x.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
            None if plan.val is None else plan.val.data_ptr(), x.data_ptr(),
            y.data_ptr(), *launch_args(plan), _ADD_CODE[add], _MUL_CODE[mul],
            ident)
    spmv_monoid.launches += 1
    return y


spmv_monoid.launches = 0
