"""Pull-direction SpMV without a plan (counterpart of
graphblast_tpu/ops/spmv.py; reference: backend/cuda/spmv.hpp:20-240 and
kernels/spmv.hpp:10-59 spmvDenseMaskedOrKernel).

    gather x at the column ids → ⊗ edge values → segmented ⊕ per row
    → mask

over raw CSR arrays, so one function serves the mxv pull (CSR), the vxm
pull (the CSC as the CSR of Aᵀ) and the algorithms that call it directly
(MIS, graph colouring, CC at n ≥ 2^24). Its routes, by semiring:
  - the structure-only LogicalOrAnd pull takes the prefix-count route: the
    or-pull kernel K5 over the packed frontier, then one gather of the row
    boundaries (K6). The JAX package takes that route on the TPU below its
    VMEM gate (`orpull_available`) and a bitmap gather above it; with no
    gate here, the bitmap gather (`_bitmap_gather`) has no caller and is
    not ported;
  - a semiring whose ⊕ is min or max (`minmax_pull.SEMIRING_MAP`) on an
    int32 or float32 frontier takes the row fold S, one kernel that
    gathers, multiplies and folds each row over the orientation's row
    schedule, which the caller passes as `sched`;
  - every other semiring and dtype gathers x (K6), applies ⊗ and reduces
    with `segops.segment_reduce_csr` in torch ops, as the JAX package does.
The TPU's sorted-gather reformulation (`spmv_pull_sorted`) waits for a
later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..semiring import LogicalOrAndSemiring, Semiring
from .gather_dispatch import take
from .kernels.bitmap_pull import pack_bitmap
from .kernels.minmax_pull import minmax_supported, spmv_minmax_pull
from .kernels.orpull import orpull_bit_csum
from .kernels.row_schedule import RowSchedule
from .segops import row_boundary_csum, segment_reduce_csr


def mask_pass(mask_dense: torch.Tensor, scmp: bool) -> torch.Tensor:
    """Mask predicate: nonzero passes, scmp complements (reference:
    kernels/assign_dense.hpp:23-28)."""
    nz = mask_dense != 0
    return ~nz if scmp else nz


def spmv_pull(row_ptr: torch.Tensor, col_ind: torch.Tensor,
              val: Optional[torch.Tensor], x_dense: torch.Tensor,
              semiring: Semiring, nrows: int,
              mask_dense: Optional[torch.Tensor] = None,
              mask_scmp: bool = False,
              structure_only: bool = False, *,
              sched: Optional[RowSchedule] = None) -> torch.Tensor:
    """y[i] = ⊕_{j ∈ A(i,:)} A[i,j] ⊗ x[j], of x's dtype; masked-out rows get
    the identity. Padded edge slots past row_ptr[nrows] belong to no row.
    `sched` is row_ptr's RowSchedule (`row_schedule.schedule_for` of the
    Matrix's orientation): a pull on the card that takes the min/max row
    fold raises without it; the CPU needs none."""
    out_dtype = x_dense.dtype
    if structure_only and semiring.name == "LogicalOrAnd":
        # an edge counts iff its frontier bit is set: the prefix count of
        # set bits, differenced at the row boundaries
        bnd = row_boundary_csum(
            orpull_bit_csum(pack_bitmap(x_dense), col_ind), row_ptr)
        y = ((bnd[1:] - bnd[:-1]) > 0).to(out_dtype)
    elif minmax_supported(semiring, out_dtype):
        y = spmv_minmax_pull(row_ptr, col_ind, val, x_dense, semiring, nrows,
                             sched=sched)
    else:
        edge = semiring.mul(val.to(out_dtype), take(x_dense, col_ind))
        y = segment_reduce_csr(edge, row_ptr, semiring.add,
                               nrows).to(out_dtype)
    if mask_dense is not None:
        # the identity as a scalar argument: a tensor of it copied to the
        # card would wait for the stream
        y = torch.where(mask_pass(mask_dense, mask_scmp), y,
                        semiring.identity(out_dtype).item())
    return y


def spmv_pull_or_fused(row_ptr: torch.Tensor, col_ind: torch.Tensor,
                       x_dense: torch.Tensor, nrows: int,
                       mask_dense: Optional[torch.Tensor] = None,
                       mask_scmp: bool = False) -> torch.Tensor:
    """The boolean BFS pull y = (A ∨.∧ x) under the mask, 0/1 of x's dtype
    (reference: kernels/spmv.hpp:10-59 spmvDenseMaskedOrKernel)."""
    return spmv_pull(row_ptr, col_ind, None, x_dense, LogicalOrAndSemiring,
                     nrows, mask_dense, mask_scmp, structure_only=True)
