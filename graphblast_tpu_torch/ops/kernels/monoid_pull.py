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

The masked entry serves SSSP's MinimumPlus pull, whose caller discards
every y[i] >= bound[i] (`spmv_monoid(..., bound=)`: `mxv_dual`'s `bound`,
SSSP's distances v, which `mxv_dual` applies as that filter). Two things
of the plain pull cannot pass that filter, and the entry skips them:
  - an edge off the frontier: x[j] = FLT_MAX, and clamp(w + FLT_MAX) =
    FLT_MAX, the identity, for every weight w >= w_min, the plan's least
    weight, where fl(FLT_MAX + w_min) rounds to FLT_MAX or above (a plan
    whose weights do not, or hold a NaN, has `w_min` None and never takes
    the entry). Each edge tests its column's bit in the frontier's packed
    bitmap (`pack_bitmap(x != FLT_MAX)`, K1's packer) first and reads
    neither x[j] nor its weight where it is clear;
  - a settled row: t = fl(min x + w_min), a float32 device scalar, is at
    most every fl(w + x[j]) since fl is monotone, so a row with bound[i]
    <= t gets no candidate under its bound. It is written FLT_MAX without
    a read of its ids (the row schedule's `row_open` hook).
The entry reads 4 B of bound, perm and y a row, the open rows' pointers
and ids, the bitmap (n_in/8 B, 4 MB at 2^25 columns, in L2), and x and a
weight only at the open rows' frontier columns. Its result equals the
plain pull at every open row and FLT_MAX at the closed ones, so after the
caller's filter it equals the plain pull's, bit for bit.

`spmv_monoid` launches the kernel for CUDA tensors and counts each launch
in `spmv_monoid.launches`, and each masked one in
`spmv_monoid.masked_launches` too; for CPU tensors it runs the plain
version, masked as the entry is.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from .bitmap_pull import pack_bitmap
from .row_schedule import (RowSchedule, launch_args, plan_schedule,
                           schedule_for)
from .value_pull import check_csr, check_x

FLT_MAX = float(np.finfo(np.float32).max)

_SIGNATURES = {
    "gb_monoid_pull": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "gb_monoid_pull_masked": ([ctypes.c_void_p] * 12, ctypes.c_int),
    "gb_monoid_pull_error_string": ([ctypes.c_int], ctypes.c_char_p)}
_LAUNCH, _LAUNCH_MASKED = (
    _build.launcher("monoid_pull", _SIGNATURES, entry,
                    "gb_monoid_pull_error_string")
    for entry in ("gb_monoid_pull", "gb_monoid_pull_masked"))

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
    that mxv_dual picks the monoid pull by the plan's type. `w_min`, the
    least weight as a 0-d float32 tensor (`least_weight`), or None, lets a
    MinimumPlus pull with a bound take the masked entry."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: Optional[torch.Tensor]
    sched: Optional[RowSchedule] = None
    w_min: Optional[torch.Tensor] = None


def least_weight(ptr: torch.Tensor,
                 val: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The least of the weights val[:ptr[-1]] as a 0-d float32 tensor on
    ptr's device, 1 where there are none (val None: every weight 1); None
    where a weight is NaN or so negative that fl(FLT_MAX + w) < FLT_MAX,
    so that skipping a column off the frontier would not be exact. One
    pass over the weights and one host read."""
    one = torch.ones((), dtype=torch.float32, device=ptr.device)
    m = int(ptr[-1]) if val is not None else 0
    if m == 0:
        return one
    w = val[:m].amin()
    return w if bool(w + FLT_MAX >= FLT_MAX) else None


def build_plan_monoid(ptr: torch.Tensor, ind: torch.Tensor,
                      val: Optional[torch.Tensor], n_out: int, n_in: int,
                      sched: Optional[RowSchedule] = None) -> MonoidPlan:
    """Check a CSR (value_pull.check_csr) and wrap it as a plan with its
    least weight. A plan on the card gets `sched`, which must be ptr's
    schedule, or a new one."""
    ptr, ind, val = check_csr(ptr, ind, val, n_out, n_in)
    return MonoidPlan(n_out, n_in, ptr, ind, val, plan_schedule(ptr, sched),
                      least_weight(ptr, val))


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


def takes_bound(plan: MonoidPlan, semiring, bound) -> bool:
    """Whether a pull with `bound` takes the masked entry: MinimumPlus,
    over a plan with columns whose least weight makes the column skip
    exact (`w_min` not None). Elsewhere the bound is ignored, which its
    contract allows."""
    return (bound is not None and semiring.name == "MinimumPlus"
            and plan.w_min is not None and plan.n_in > 0)


def _check_bound(plan: MonoidPlan, bound: torch.Tensor):
    if bound.dtype != torch.float32 or bound.dim() != 1:
        raise TypeError("bound must be a 1-D float32 tensor")
    if bound.shape[0] != plan.n_out or bound.device != plan.ptr.device:
        raise ValueError(f"a bound of {bound.shape[0]} entries on "
                         f"{bound.device}, the plan has {plan.n_out} rows "
                         f"on {plan.ptr.device}")


def pull_threshold(plan: MonoidPlan, x: torch.Tensor) -> torch.Tensor:
    """t = fl(min x + w_min), a 0-d float32 tensor on x's device, computed
    there with no host read: no row's candidate lies below it."""
    return x.min() + plan.w_min


def spmv_monoid_plain(plan: MonoidPlan, x: torch.Tensor, semiring,
                      bound: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, in float32 and the kernel's order: gather x,
    ⊗, clamp to ±FLT_MAX, then scatter_reduce amin/amax into y filled with
    the identity. With a bound that the masked entry takes
    (`takes_bound`), the rows with bound <= `pull_threshold` keep the
    identity and the edges whose x is FLT_MAX are skipped, as there."""
    add, mul, ident = _ops(semiring)
    ptr = plan.ptr.long()
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    cols = plan.ind[:m].long()
    a = plan.val[:m] if plan.val is not None else None
    if takes_bound(plan, semiring, bound):
        keep = ((~(bound <= pull_threshold(plan, x)))[rows]
                & (x != FLT_MAX)[cols])
        rows, cols = rows[keep], cols[keep]
        a = a[keep] if a is not None else None
    p = x[cols]
    if mul != "second":
        a = a if a is not None else torch.ones_like(p)
        p = a + p if mul == "plus" else a * p
    p = p.clamp(-FLT_MAX, FLT_MAX)
    y = torch.full((plan.n_out,), ident, dtype=torch.float32,
                   device=ptr.device)
    return y.scatter_reduce_(0, rows, p, "a" + add, include_self=True)


def spmv_monoid(plan: MonoidPlan, x: torch.Tensor, semiring,
                bound: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The monoid pull of `semiring` (a SEMIRING_MAP entry) for the plan's
    orientation (float32, (n_out,)). `bound` (float32, (n_out,)) promises
    that the caller discards every y[i] >= bound[i]: a MinimumPlus pull
    then takes the masked entry where `takes_bound` allows, and its y
    differs from the plain pull's only there. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream, or
    raise (a plan with no schedule too)."""
    add, mul, ident = _ops(semiring)
    check_x(plan, x)
    masked = takes_bound(plan, semiring, bound)
    if masked:
        _check_bound(plan, bound)
    if x.device.type == "cpu":
        return spmv_monoid_plain(plan, x, semiring, bound)
    if x.device.type != "cuda":
        raise ValueError(f"no monoid pull for device {x.device}")
    y = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    val = None if plan.val is None else plan.val.data_ptr()
    if masked:
        words = pack_bitmap(x != FLT_MAX)
        t = pull_threshold(plan, x)
        bound = bound.contiguous()
        _LAUNCH_MASKED(x.get_device(), plan.ptr.data_ptr(),
                       plan.ind.data_ptr(), val, x.data_ptr(),
                       words.data_ptr(), bound.data_ptr(), t.data_ptr(),
                       y.data_ptr(), *launch_args(plan))
        spmv_monoid.masked_launches += 1
    else:
        _LAUNCH(x.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
                val, x.data_ptr(), y.data_ptr(), *launch_args(plan),
                _ADD_CODE[add], _MUL_CODE[mul], ident)
    spmv_monoid.launches += 1
    return y


spmv_monoid.launches = 0
spmv_monoid.masked_launches = 0
