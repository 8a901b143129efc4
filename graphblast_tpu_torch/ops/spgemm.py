"""Masked SpGEMM, its structural count, and the trace of A ⊕.⊗ Bᵀ
(counterpart of graphblast_tpu/ops/spgemm.py; reference:
backend/cuda/spgemm.hpp:22-110 spgemmMasked with the warp kernel
kernels/spgemm.hpp:17-79, and trace.hpp:13-49).

For each stored (i, j) of the mask M, C[i, j] is the semiring dot of A's row
i and B's column j (B's row j when B is taken transposed, TC's idiom): an
intersection of two sorted id lists. All three operations run on T1 and T2
(ops/kernels/masked_intersect.py) over an intersection schedule
(ops/kernels/intersect_schedule.py: each edge's route, bitmap or search,
and the work units), built once per mask and pair of operands and cached
in the mask's plans (the trace's in A's); each has a plain version,
`*_plain`, beside it, which the tests and the CPU path use.

Not ported: the unmasked `spgemm_esc` and its dense fallback (ROADMAP queue
1 item 7), and `_mask_chunk_plan`'s host chunking, lane caps and knobs
(GRB_SPGEMM_LANES, GRB_SPGEMM_MINSIDE). Those fit the TPU's memory; the
kernel stores no expansion, and its schedule picks each edge's route.
"""
from __future__ import annotations

import torch

from .. import dimension as dim
from ..matrix import Matrix
from ..semiring import Semiring
from ..types import INDEX_DTYPE, SparseFormat
from .kernels.intersect_schedule import (IntersectSchedule,
                                         build_intersect_schedule)
from .kernels.masked_intersect import (masked_intersect_count,
                                       masked_intersect_count_plain,
                                       masked_intersect_fold,
                                       masked_intersect_fold_plain)

# schedules kept per mask (or per A, for the trace): those of the most
# recently used pairs of A's and B's pointer tensors
SCHEDULES_KEPT = 4


def _check_lists(X: Matrix, orient: str) -> None:
    """Raise unless every list of X's `orient` ("csr" or "csc") is sorted
    with no duplicate ids, the walk's precondition (the JAX package's,
    spgemm.py:381-382). Checked once per Matrix and orientation."""
    key = orient + "/sorted"
    if X._plans.get(key):
        return
    ptr, ind = ((X.row_ptr, X.col_ind) if orient == "csr"
                else (X.col_ptr, X.csc_row_ind))
    m = X.nvals
    if m > 1:
        heads = torch.zeros(m, dtype=torch.bool, device=ptr.device)
        starts = ptr[:-1].long()
        heads[starts[starts < m]] = True
        if not bool(((ind[1:m] > ind[: m - 1]) | heads[1:]).all()):
            raise ValueError(f"masked SpGEMM needs each list of the "
                             f"{orient.upper()} sorted with no duplicate "
                             "ids")
    X._plans[key] = True


def _operands(A: Matrix, B: Matrix, M: Matrix, transpose_b: bool) -> tuple:
    """(mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val) of the walk: the
    mask's stored entries, A's CSR and B's rows (transpose_b) or its CSC."""
    inner, n_out = (B.ncols, B.nrows) if transpose_b else (B.nrows, B.ncols)
    if A.ncols != inner or M.shape != (A.nrows, n_out):
        raise dim.DimensionException(
            f"masked SpGEMM: dimension mismatch — A is {A.shape}, "
            f"B{'ᵀ' if transpose_b else ''} is {(inner, n_out)}, the mask "
            f"is {M.shape}")
    if A.row_ptr is None or M.row_ptr is None:
        raise ValueError("masked SpGEMM needs A's and the mask's CSR")
    b = ((B.row_ptr, B.col_ind, B.val) if transpose_b
         else (B.col_ptr, B.csc_row_ind, B.csc_val))
    if b[0] is None:
        raise ValueError("masked SpGEMM needs B's CSC (or its CSR with "
                         "transpose_b)")
    _check_lists(A, "csr")
    _check_lists(B, "csr" if transpose_b else "csc")
    m = M.nvals
    return (M.row_ind[:m], M.col_ind[:m], A.row_ptr, A.col_ind, A.val) + b


def schedule_for(holder: Matrix, ops: tuple, n_ids: int, fold: bool,
                 trace: bool = False) -> IntersectSchedule:
    """The intersection schedule of the walk `ops` (`_operands`, or
    `_diagonal_operands` when `trace`) over ids below n_ids, built on the
    first call and cached in holder._plans: the mask, or A for the trace.
    An entry holds A's and B's pointer tensors themselves, so only the
    same operands hit it, and T1 and T2 keep one each (their bitmap
    budgets differ)."""
    mi, mj, a_ptr, _, _, b_ptr, _, _ = ops
    cache = holder._plans.setdefault(
        "intersect/trace" if trace else "intersect/mask", [])
    for k, (a, b, sched) in enumerate(cache):
        if a is a_ptr and b is b_ptr and sched.fold == fold:
            cache.append(cache.pop(k))   # the most recently used goes last
            return sched
    sched = build_intersect_schedule(mi, mj, a_ptr, b_ptr, n_ids, fold)
    cache.append((a_ptr, b_ptr, sched))
    del cache[:-SCHEDULES_KEPT]
    return sched


def _count_args(ops: tuple) -> tuple:
    mi, mj, a_ptr, a_ind, _, b_ptr, b_ind, _ = ops
    return mi, mj, a_ptr, a_ind, b_ptr, b_ind


def spgemm_masked_count(A: Matrix, B: Matrix, M: Matrix,
                        transpose_b: bool = False) -> int:
    """Σ_{(i,j)∈M} |N_A(i) ∩ N_B(j)|, the structural masked-SpGEMM total
    that triangle counting reads (values count as 1): one T1 launch, or its
    plain version on CPU tensors."""
    ops = _operands(A, B, M, transpose_b)
    return masked_intersect_count(
        *_count_args(ops), sched=schedule_for(M, ops, A.ncols, False))


def spgemm_masked_count_plain(A: Matrix, B: Matrix, M: Matrix,
                              transpose_b: bool = False) -> int:
    """Plain PyTorch version of `spgemm_masked_count`."""
    return masked_intersect_count_plain(
        *_count_args(_operands(A, B, M, transpose_b)))


def _masked_result(M: Matrix, c: torch.Tensor) -> Matrix:
    """C with M's sparsity (reference spgemm.hpp:85-87, C.dup(mask)), its
    values padded with zeros as every Matrix's are; CSR only."""
    val = torch.zeros(M.nnz_pad, dtype=c.dtype, device=c.device)
    val[: M.nvals] = c
    return Matrix(M.nrows, M.ncols, M.nvals, M.row_ptr, M.col_ind,
                  M.row_ind, val, None, None, None, None,
                  format=SparseFormat.CSRONLY, symmetric=False)


def spgemm_masked(A: Matrix, B: Matrix, M: Matrix, semiring: Semiring,
                  transpose_b: bool = False) -> Matrix:
    """C = (A ⊕.⊗ B, or A ⊕.⊗ Bᵀ) on the structure of M, in A's dtype: one
    T2 launch. ⊕'s identity joins an entry where its lists share fewer ids
    than the shorter holds, as in the JAX package's join, so an entry whose
    lists share no id holds the identity. Needs A's CSR, M's CSR and B's
    CSC (its CSR when transpose_b)."""
    ops = _operands(A, B, M, transpose_b)
    return _masked_result(M, masked_intersect_fold(
        *ops, semiring, sched=schedule_for(M, ops, A.ncols, True)))


def spgemm_masked_plain(A: Matrix, B: Matrix, M: Matrix, semiring: Semiring,
                        transpose_b: bool = False) -> Matrix:
    """Plain PyTorch version of `spgemm_masked`."""
    return _masked_result(M, masked_intersect_fold_plain(
        *_operands(A, B, M, transpose_b), semiring))


def _diagonal_operands(A: Matrix, B: Matrix) -> tuple:
    """The walk of Tr(A ⊕.⊗ Bᵀ): the pairs (i, i) over A's and B's rows."""
    if A.shape != B.shape:
        raise dim.DimensionException(
            f"trace_mxm_transpose: dimension mismatch — A is {A.shape}, B "
            f"is {B.shape}")
    if A.row_ptr is None or B.row_ptr is None:
        raise ValueError("trace_mxm_transpose needs A's and B's CSR")
    _check_lists(A, "csr")
    _check_lists(B, "csr")
    ids = torch.arange(A.nrows, dtype=INDEX_DTYPE, device=A.device)
    return (ids, ids, A.row_ptr, A.col_ind, A.val, B.row_ptr, B.col_ind,
            B.val)


def _trace_total(A: Matrix, c: torch.Tensor,
                 semiring: Semiring) -> torch.Tensor:
    """⊕ of the rows' values c, a 0-d tensor of c's dtype. The JAX package
    reduces one value for each of A's nnz_pad slots, its padded slots
    holding the identity (spgemm.py:712-723), so the identity joins where
    A has padded slots; min and max are the ⊕ that see it."""
    add = semiring.add.name
    ident = semiring.identity(c.dtype).to(c.device)
    if c.shape[0] == 0:
        return ident
    if add == "PlusMonoid":
        return c.sum(dtype=c.dtype)
    if add == "LogicalOrMonoid":
        return (c != 0).any().to(c.dtype)
    total = c.min() if add == "MinimumMonoid" else c.max()
    return semiring.add(total, ident) if A.nnz_pad > A.nvals else total


def intersect_rows_reduce(A: Matrix, B: Matrix,
                          semiring: Semiring) -> torch.Tensor:
    """Tr(A ⊕.⊗ Bᵀ) = ⊕_i ⊕_{k ∈ row_A(i) ∩ row_B(i)} A[i,k] ⊗ B[i,k], with
    ⊕'s identity joined as the JAX package's trace joins it (where A's row
    holds an id B's lacks, and for A's padded slots): one T2 launch over
    the diagonal pairs (i, i), then one ⊕ reduce of the n values. A 0-d
    tensor of A's dtype."""
    ops = _diagonal_operands(A, B)
    sched = schedule_for(A, ops, A.ncols, True, trace=True)
    return _trace_total(A, masked_intersect_fold(
        *ops, semiring, trace=True, sched=sched), semiring)


def intersect_rows_reduce_plain(A: Matrix, B: Matrix,
                                semiring: Semiring) -> torch.Tensor:
    """Plain PyTorch version of `intersect_rows_reduce`."""
    return _trace_total(A, masked_intersect_fold_plain(
        *_diagonal_operands(A, B), semiring, trace=True), semiring)
