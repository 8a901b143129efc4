"""Direction-optimized mxv/vxm dispatch (counterpart of
graphblast_tpu/ops/dispatch.py; reference: backend/cuda/operations.hpp:82-327
and the direction heuristic, backend/cuda/vector.hpp:292-323).

Ported so far: the DualFrontier carry, the direction heuristic, and the
PULLONLY branch of `mxv_dual` (dispatch.py:255-296 of the JAX package): over
a plan, the structure-only LogicalOrAnd pull over a bitmap plan (K1, fused
BFS) or a unit-valued value plan, the PlusMultiplies pull over a value plan
(K2/K3), and the min/max semirings of the monoid pull over a monoid plan
(K4, SSSP); with no plan, `spmv_pull` over the pull orientation (K5 and K6
for stepped BFS, the row fold S for a min/max semiring, with the
orientation's cached row schedule), as the JAX package pulls when it has no
plan and no TPU; and the `postprocess` epilogue. Push, and therefore
PUSHONLY and PUSHPULL, is ROADMAP queue 1 item 5: it raises
NotImplementedError here rather than run another path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..matrix import Matrix
from ..semiring import Semiring
from ..types import INDEX_DTYPE, Direction
from ..vector import dense_from_sparse, sparse_from_dense
from .kernels.bitmap_pull import BitmapPlan, pack_bitmap, spmv_bitmap_pull
from .kernels.minmax_pull import minmax_supported
from .kernels.monoid_pull import MonoidPlan, monoid_supported, spmv_monoid
from .kernels.row_schedule import schedule_for
from .kernels.value_pull import ValuePlan, spmv_value_pull
from .spmv import mask_pass, spmv_pull

PUSH_TODO = ("push (PUSHONLY / PUSHPULL) is not ported yet: ROADMAP queue 1 "
             "item 5; run pull-only with mode=Direction.PULLONLY")


@dataclasses.dataclass(frozen=True)
class DualFrontier:
    """Frontier with both storage images and the direction preference.

    dense (n,), sind (cap,), sval (cap,) or None, snvals, ratio and
    use_sparse as tensors on the frontier's device. A pull-only loop keeps
    the sparse image stale: only push reads it.
    """

    n: int
    dense: torch.Tensor
    sind: torch.Tensor
    sval: Optional[torch.Tensor]
    snvals: torch.Tensor
    ratio: torch.Tensor       # previous nnz/n (hysteresis state)
    use_sparse: torch.Tensor  # bool: push preferred

    @staticmethod
    def from_dense(dense: torch.Tensor, identity,
                   prefer_sparse: bool = False) -> "DualFrontier":
        n = dense.shape[0]
        sind, sval, nv = sparse_from_dense(dense, identity)
        return DualFrontier(n, dense, sind, sval, nv, nv.float() / n,
                            torch.tensor(prefer_sparse, device=dense.device))

    @staticmethod
    def from_sparse(n: int, sind, sval, snvals, identity) -> "DualFrontier":
        dense = dense_from_sparse(n, sind, sval, snvals, identity)
        return DualFrontier(n, dense, sind, sval, snvals,
                            snvals.float() / n,
                            torch.tensor(True, device=dense.device))


def update_direction(nv: torch.Tensor, n: int, prev_ratio, prev_sparse,
                     switchpoint: float, mode) -> tuple:
    """The convert() heuristic with hysteresis (reference:
    vector.hpp:292-323): sparse→dense when density > switchpoint and rising,
    dense→sparse when density ≤ switchpoint and falling. Returns
    (use_sparse, ratio)."""
    ratio = nv.float() / n
    if mode == Direction.PUSHONLY:
        return torch.tensor(True, device=nv.device), ratio
    if mode == Direction.PULLONLY:
        return torch.tensor(False, device=nv.device), ratio
    rising = ratio >= prev_ratio
    use_sparse = torch.where(
        ratio > switchpoint,
        torch.where(rising, torch.tensor(False, device=nv.device),
                    prev_sparse),
        torch.where(~rising, torch.tensor(True, device=nv.device),
                    prev_sparse))
    return use_sparse, ratio


def mxv_dual(A: Matrix, f: DualFrontier, semiring: Semiring, identity, *,
             transpose: bool = False,
             mask_dense: Optional[torch.Tensor] = None,
             mask_scmp: bool = False, structure_only: bool = False,
             switchpoint: float = 0.01, mode=None, pull_plan=None,
             postprocess: Optional[Callable] = None):
    """One y = A ⊗ f (or fᵀ ⊗ A when transpose), returning a new
    DualFrontier and whether push ran (reference: operations.hpp:108-199
    vxm + convert()).

    Only the pull branch exists: `mode` must resolve to PULLONLY.
    `pull_plan` is None, for `spmv_pull` over the pull orientation's arrays
    (CSC for vxm, CSR for mxv) with any semiring, or a plan of that
    orientation: a BitmapPlan for the structure-only LogicalOrAnd pull, a
    ValuePlan for that pull (unit values only) or the PlusMultiplies pull,
    or a MonoidPlan for a min/max semiring of SEMIRING_MAP over a float32
    frontier. `postprocess(y)` runs after the mask and before the count of
    non-identity entries, as in the JAX PULLONLY branch. The JAX signature's
    push workspace arguments (edge_cap, sort_push, tier_divisors, lazy,
    postprocess_sparse) come with push."""
    mode = mode if mode is not None else Direction.PUSHPULL
    n_out, _, pull_ptr, pull_ind, pull_val = A.pull_csr(transpose)
    push_ptr = A.row_ptr if transpose else A.col_ptr
    if push_ptr is None:   # one-sided storage forces one direction
        mode = Direction.PULLONLY
    if pull_ptr is None:
        mode = Direction.PUSHONLY
    if mode != Direction.PULLONLY:
        raise NotImplementedError(PUSH_TODO)
    or_pull = structure_only and semiring.name == "LogicalOrAnd"
    if isinstance(pull_plan, MonoidPlan):
        missing = [why for why, bad in (
            ("a pull that reads values (structure_only is set)",
             structure_only),
            (f"a semiring of SEMIRING_MAP ({semiring.name} is not)",
             not monoid_supported(semiring)),
            (f"a float32 frontier ({f.dense.dtype} given)",
             f.dense.dtype != torch.float32)) if bad]
        if missing:
            raise NotImplementedError("the monoid pull needs "
                                      + " and ".join(missing))
    elif isinstance(pull_plan, ValuePlan):
        if not (or_pull or (not structure_only
                            and semiring.name == "PlusMultiplies")):
            raise NotImplementedError(
                f"the {semiring.name} pull over a value plan is not ported: "
                "the min/max semirings run over a MonoidPlan "
                "(plan_for_monoid, K4 of ROADMAP queue 2)")
        if or_pull and not pull_plan.unit_vals:
            # count>0 is the fused-or result only when every edge value is
            # 1: cancelling weights could sum to 0 for a reached vertex
            raise ValueError("the LogicalOrAnd pull needs a bitmap plan or a "
                             "unit-valued (ones=True) value plan")
    elif pull_plan is not None and not (or_pull and isinstance(pull_plan,
                                                               BitmapPlan)):
        raise NotImplementedError(
            f"the {semiring.name} pull over a {type(pull_plan).__name__} "
            "is not ported; pass no plan for spmv_pull")
    if pull_plan is not None and pull_plan.n_out != n_out:
        raise ValueError(f"plan has {pull_plan.n_out} output rows, the "
                         f"{'vxm' if transpose else 'mxv'} pull needs {n_out}")

    if pull_plan is None:   # the mask is applied below, for every route
        # only the min/max row fold reads a schedule
        sched = (schedule_for(A, transpose)
                 if minmax_supported(semiring, f.dense.dtype) else None)
        y = spmv_pull(pull_ptr, pull_ind, pull_val, f.dense, semiring, n_out,
                      structure_only=structure_only, sched=sched)
    elif isinstance(pull_plan, MonoidPlan):
        y = spmv_monoid(pull_plan, f.dense, semiring)
    else:
        if isinstance(pull_plan, BitmapPlan):
            # the bitmap plan ignores edge values
            cnt = spmv_bitmap_pull(pull_plan, pack_bitmap(f.dense))
        else:   # the kernel computes in float32, as the JAX kernel does
            cnt = spmv_value_pull(pull_plan, f.dense.to(torch.float32))
        # count>0 is the fused-or result
        y = (cnt > 0 if or_pull else cnt).to(f.dense.dtype)
    if mask_dense is not None:
        y = y.masked_fill(~mask_pass(mask_dense, mask_scmp),
                          semiring.identity(y.dtype).item())
    if postprocess is not None:
        y = postprocess(y)
    # pull-only loops skip re-sparsifying: only push reads sind/sval
    nv = (y != identity).sum().to(INDEX_DTYPE)
    use_sparse, ratio = update_direction(nv, n_out, f.ratio, f.use_sparse,
                                         switchpoint, mode)
    return (DualFrontier(n_out, y, f.sind, f.sval, nv, ratio, use_sparse),
            False)
