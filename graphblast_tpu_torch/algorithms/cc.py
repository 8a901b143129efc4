"""Connected components, FastSV (counterpart of
graphblast_tpu/algorithms/cc.py; reference:
graphblas/algorithm/cc.hpp:17-136, after Zhang/Azad/Hu SIAM PP20).

Per iteration, on dense int32 vectors:
  1. stochastic hooking   mnp_t = mxv(MinimumSelectSecond, A, gp)
                          mnp   = min(mnp, mnp_t)
                          parent[parent_temp] min= mnp
  2. aggressive hooking   parent = min(parent, mnp)
  3. shortcutting         parent = min(parent, parent_temp)
  4. grandparents         gp = parent[parent]
  5. termination          succ = sum(gp_temp != gp)
  6. filter               gp = INT_MAX where unchanged

Below n = 2^24 the select-second pull runs the monoid pull (K4) over A's
unit-valued CSR plan on the float32 image of gp: ids below 2^24 are exact in
float32, INT_MAX becomes 2^31 >= n, and the cast back happens on a value
clamped to n (cc.py:51-53 of the JAX package). From 2^24 on, float32 no
longer holds every id, and the pull is the plan-less `spmv_pull` on the
int32 gp over the CSR with int32 values (cc.py:55-56): on the card one
launch of the min/max row fold S per iteration, over the CSR's cached row
schedule. The hooking scatter combines by min, as the JAX package's does
(the reference's scatter is last-write-wins). Both modes are a Python loop
with one host read of `succ` per iteration.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.kernels.monoid_pull import (MonoidPlan, plan_for_monoid,
                                       spmv_monoid)
from ..ops.kernels.row_schedule import schedule_for
from ..ops.spmv import spmv_pull
from ..semiring import MinimumSelectSecondSemiring
from ..vector import Vector
from .common import TightTimer, dense_result, print_iter_row

IMAX = torch.iinfo(torch.int32).max
# float32 holds every integer below 2^24 exactly
EXACT_IDS = 1 << 24


def _cc_step(A: Matrix, parent, mnp, gp, gp_t, pull):
    """One FastSV iteration. `pull` is a MonoidPlan of A's CSR, or the CSR
    as (ptr, ind, int32 val, its RowSchedule) for the plan-less pull."""
    n = A.nrows
    parent_temp = parent
    # 1) stochastic hooking: mnp_t[i] = min over j in A(i,:) of gp[j]
    if isinstance(pull, MonoidPlan):
        yf = spmv_monoid(pull, gp.to(torch.float32),
                         MinimumSelectSecondSemiring)
        mnp_t = torch.where(yf >= n, IMAX, yf.clamp(max=n).to(torch.int32))
    else:
        ptr, ind, val, sched = pull
        mnp_t = spmv_pull(ptr, ind, val, gp, MinimumSelectSecondSemiring, n,
                          sched=sched)
    mnp = torch.minimum(mnp, mnp_t)
    # f[f[u]] = mngf[u], combined by min
    parent = parent.scatter_reduce(0, parent_temp.long(), mnp, "amin",
                                   include_self=True)
    # 2) aggressive hooking + 3) shortcutting (eWiseAdd Minimum, cc.hpp:90-98)
    parent = torch.minimum(parent, mnp)
    parent = torch.minimum(parent, parent_temp)
    # 4) grandparent: gp[u] = parent[parent[u]] (extractGather, cc.hpp:101-103)
    gp = parent[parent.clamp(0, n - 1).long()]
    # 5) termination (eWiseMult MinimumNotEqualTo + reduce, cc.hpp:106-109)
    diff = gp_t != gp
    succ = diff.sum()
    # 6) unproductive filter (scmp-masked assign INT_MAX, cc.hpp:115-119)
    return parent, mnp, torch.where(diff, gp, IMAX), gp, succ


def _cc_fused(A: Matrix, plan: Optional[MonoidPlan], *, max_niter: int,
              timing: int = 0):
    """The FastSV loop from parent = 0..n-1: `it` starts at 1 and the loop
    runs while succ > 0 and it <= max_niter. With plan None it pulls
    without a plan, at any n. Returns (parent, iterations run)."""
    n = A.nrows
    # the plan-less pull casts the values once per call, as JAX's
    # _as_int_matrix does, and reads the CSR's cached row schedule
    pull = plan if plan is not None else (A.row_ptr, A.col_ind,
                                          A.val.to(torch.int32),
                                          schedule_for(A, transpose=False))
    parent = torch.arange(n, dtype=torch.int32, device=A.device)
    mnp = gp = gp_t = parent
    timer = TightTimer() if timing else None
    it, succ = 1, 1
    while succ > 0 and it <= max_niter:
        if timing:
            timer.start()
        parent, mnp, gp, gp_t, succ_t = _cc_step(A, parent, mnp, gp, gp_t,
                                                 pull)
        succ = int(succ_t)          # the one host sync of the iteration
        if timing:
            print_iter_row(it, succ, n, n, False, timer.stop(parent), timing)
        it += 1
    return parent, it - 1


def cc(A: Matrix, seed: int = 0, desc: Descriptor = DEFAULT,
       mode: str = "fused") -> Vector:
    """Component labels, int32: the least vertex id of each component, as
    FastSV gives them on a symmetric graph. Runs on A's device. `seed` is
    accepted for the JAX signature and unused there too. Any mode but
    "fused" runs stepped, as in the JAX package."""
    if A.row_ptr is None:
        raise NotImplementedError(
            "cc needs A's CSR, which it pulls over; the JAX package has no "
            "route for a CSC-only matrix either")
    plan = (plan_for_monoid(A, transpose=False, ones=True)
            if A.nrows < EXACT_IDS else None)
    parent, _ = _cc_fused(A, plan, max_niter=desc.max_niter,
                          timing=desc.timing if mode != "fused" else 0)
    return dense_result(A.nrows, parent)


def cc_cpu(A: Matrix):
    """Golden CPU reference passthrough (reference: test_cc.hpp)."""
    from .reference import cc_cpu as _impl

    return _impl(A)


def verify_cc(A: Matrix, labels) -> bool:
    from .reference import verify_cc as _impl

    return _impl(A, labels)
