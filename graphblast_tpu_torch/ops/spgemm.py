"""Masked SpGEMM, its structural count, the trace of A ⊕.⊗ Bᵀ, and the
unmasked SpGEMM (counterpart of graphblast_tpu/ops/spgemm.py; reference:
backend/cuda/spgemm.hpp:22-110 spgemmMasked with the warp kernel
kernels/spgemm.hpp:17-79, trace.hpp:13-49, and cusparse csrgemm2,
spgemm.hpp:282-508).

For each stored (i, j) of the mask M, C[i, j] is the semiring dot of A's row
i and B's column j (B's row j when B is taken transposed, TC's idiom): an
intersection of two sorted id lists. All three operations run on T1 and T2
(ops/kernels/masked_intersect.py) over an intersection schedule
(ops/kernels/intersect_schedule.py: each edge's route, bitmap or search,
and the work units), built once per mask and pair of operands and cached
in the mask's plans (the trace's in A's); each has a plain version,
`*_plain`, beside it, which the tests and the CPU path use.

The unmasked product (`spgemm`) takes the ESC route, expand, sort and
compress (`spgemm_esc`), or below `dense_limit` output entries a dense
product. The ESC is torch ops around `take`, whose gathers launch the
gather kernel K6, as the JAX package's are jnp around its `take`:
  expand    each A entry (i, k) over B's row k, in chunks of at most
            `max_lanes` lanes: the push's lane expansion
            (`spmspv.expand_lanes`, a cumsum of run starts and a gather in
            place of JAX's cummax forward fill, which torch runs in one
            block on the card), then the gathers of j, A's and B's values
            and i;
  sort      the products stably by (i, j), so that duplicates fold in one
            fixed order: min, max and logical-or equal JAX's exactly, and a
            float sum differs from JAX's (whose sort is unstable) only in
            its order;
  compress  a segmented ⊕ scan over each run of one (i, j), its tail kept,
            compacted by a cumsum.
Chunks merge by one more sort and compress, and the result is built on the
card (`Matrix.from_device_coo`).

Not ported: `_mask_chunk_plan`'s host chunking, lane caps and knobs
(GRB_SPGEMM_LANES, GRB_SPGEMM_MINSIDE). Those fit the TPU's memory; the
masked kernel stores no expansion, and its schedule picks each edge's
route.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dimension as dim
from ..matrix import Matrix
from ..semiring import Monoid, Semiring
from ..types import INDEX_DTYPE, SparseFormat, round_up
from .gather_dispatch import take
from .kernels.intersect_schedule import (IntersectSchedule,
                                         build_intersect_schedule)
from .kernels.masked_intersect import (masked_intersect_count,
                                       masked_intersect_count_plain,
                                       masked_intersect_fold,
                                       masked_intersect_fold_plain, ordered)
from .segops import reduce_dim, segmented_scan
from .spmspv import expand_lanes

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


def _walks_nothing(M: Matrix, ops: tuple) -> torch.Tensor:
    """A 0-d bool tensor, on the operands' device (no host read): whether
    no mask edge walks a lane, the walked list being the shorter (B's only
    when strictly shorter). The JAX plan is None there and its result
    zeros (graphblast_tpu/ops/spgemm.py:322-323, 447-453). It depends on
    the structure alone, so it is computed once per mask and operands and
    kept in M._plans beside the intersection schedules."""
    mi, mj, a_ptr, _, _, b_ptr, _, _ = ops
    cache = M._plans.setdefault("intersect/empty", [])
    for a, b, flag in cache:
        if a is a_ptr and b is b_ptr:
            return flag
    mi64, mj64 = mi.long(), mj.long()
    len_a = a_ptr[mi64 + 1] - a_ptr[mi64]
    len_b = b_ptr[mj64 + 1] - b_ptr[mj64]
    flag = torch.minimum(len_a, len_b).sum() == 0
    cache.append((a_ptr, b_ptr, flag))
    del cache[:-SCHEDULES_KEPT]
    return flag


def _masked_result(M: Matrix, c: torch.Tensor, ops: tuple) -> Matrix:
    """C with M's sparsity (reference spgemm.hpp:85-87, C.dup(mask)), its
    values padded with zeros as every Matrix's are; CSR only. All zeros
    where no mask edge walks a lane, as in the JAX package."""
    val = torch.zeros(M.nnz_pad, dtype=c.dtype, device=c.device)
    val[: M.nvals] = torch.where(_walks_nothing(M, ops), 0, c)
    return Matrix(M.nrows, M.ncols, M.nvals, M.row_ptr, M.col_ind,
                  M.row_ind, val, None, None, None, None,
                  format=SparseFormat.CSRONLY, symmetric=False)


def spgemm_masked(A: Matrix, B: Matrix, M: Matrix, semiring: Semiring,
                  transpose_b: bool = False) -> Matrix:
    """C = (A ⊕.⊗ B, or A ⊕.⊗ Bᵀ) on the structure of M, in A's dtype: one
    T2 launch. ⊕'s identity joins an entry where its lists share fewer ids
    than the shorter holds, as in the JAX package's join, so an entry whose
    lists share no id holds the identity; an ordered ⊕ (multiplies, the
    comparisons) folds the JAX join's lanes in its order. Where no mask
    edge walks a lane, C is zeros, as the JAX package's. Needs A's CSR,
    M's CSR and B's CSC (its CSR when transpose_b)."""
    ops = _operands(A, B, M, transpose_b)
    sched = (None if ordered(semiring)    # the ordered fold reads none
             else schedule_for(M, ops, A.ncols, True))
    return _masked_result(M, masked_intersect_fold(*ops, semiring,
                                                   sched=sched), ops)


def spgemm_masked_plain(A: Matrix, B: Matrix, M: Matrix, semiring: Semiring,
                        transpose_b: bool = False) -> Matrix:
    """Plain PyTorch version of `spgemm_masked`."""
    ops = _operands(A, B, M, transpose_b)
    return _masked_result(M, masked_intersect_fold_plain(*ops, semiring),
                          ops)


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


# ------------------------------------------------------ the unmasked SpGEMM
# the row id of a lane that holds no product: it sorts past every real row
ROW_SENTINEL = (1 << 31) - 1


def _sort_dedup_coo(i: torch.Tensor, j: torch.Tensor, v: torch.Tensor,
                    add_monoid: Monoid, ncols: int):
    """Sort COO triples by (i, j), ⊕-combine duplicates and compact the
    unique entries to the front (the ESC's tail; reference: CUB radix sort
    + mgpu ReduceByKey, as csrgemm2 does). Lanes with i == ROW_SENTINEL
    hold nothing and sort last. The sort is stable, so a run of one (i, j)
    folds its lanes in their order. Returns (ci, cj, cv, n_unique): ci
    pads with ROW_SENTINEL past n_unique, a 0-d int32 tensor."""
    cap = i.shape[0]
    perm = torch.sort(i.long() * ncols + j.long(), stable=True).indices
    i_s, j_s, v_s = i[perm], j[perm], v[perm]
    same = (i_s[1:] == i_s[:-1]) & (j_s[1:] == j_s[:-1])
    one = torch.ones(1, dtype=torch.bool, device=i.device)
    scanned = segmented_scan(v_s, torch.cat([one, ~same]), add_monoid)
    keep = torch.cat([~same, one]) & (i_s < ROW_SENTINEL)
    pos = torch.cumsum(keep, 0, dtype=INDEX_DTYPE) - 1
    tgt = torch.where(keep, pos, cap).long()
    ci = torch.full((cap + 1,), ROW_SENTINEL, dtype=INDEX_DTYPE,
                    device=i.device)
    cj = torch.zeros(cap + 1, dtype=INDEX_DTYPE, device=i.device)
    cv = v.new_zeros(cap + 1)
    ci[tgt], cj[tgt], cv[tgt] = i_s, j_s, scanned
    return ci[:cap], cj[:cap], cv[:cap], keep.sum().to(INDEX_DTYPE)


def _esc_chunk(ai: torch.Tensor, ak: torch.Tensor, av: torch.Tensor,
               b_ptr: torch.Tensor, b_ind: torch.Tensor, b_val: torch.Tensor,
               expand_cap: int, semiring: Semiring, a_sorted_by_k: bool,
               ncols: int):
    """Expand one chunk of A entries (i, k, a) over B's rows and dedup the
    products: A(i,k) ⊗ B(k,j) for every stored B(k,j), ⊕-combined by (i, j)
    (`_sort_dedup_coo`). `expand_cap` lanes hold the chunk's products. The
    gathers at B's edge ids ascend when the chunk's A entries are ordered
    by k (A's CSC order), and are filed so."""
    dtype = av.dtype
    src, b_idx, total = expand_lanes(b_ptr, b_ind.shape[0], ak,
                                     ak.shape[0], expand_cap)
    j = take(b_ind, b_idx, sorted=a_sorted_by_k)
    prod = semiring.mul(take(av, src, sorted=True).to(dtype),
                        take(b_val, b_idx, sorted=a_sorted_by_k).to(dtype))
    lane_valid = torch.arange(expand_cap, dtype=INDEX_DTYPE,
                              device=ai.device) < total
    i = torch.where(lane_valid, take(ai, src, sorted=True), ROW_SENTINEL)
    return _sort_dedup_coo(i, j, prod.to(dtype), semiring.add, ncols)


def spgemm_esc(A: Matrix, B: Matrix, semiring: Semiring,
               transpose_b: bool = False,
               max_lanes: int = 1 << 23) -> Matrix:
    """Unmasked C = A ⊕.⊗ (B, or Bᵀ with transpose_b), any semiring, by ESC
    (expand, sort, compress), in A's dtype, on A's device.

    The exact expansion size Σ_k nnz_A(:,k)·nnz_B(k,:) is computed on the
    host (the analog of csrgemm2's nnz analysis, spgemm.hpp:365-414), and
    A's entries are cut into chunks of at most `max_lanes` products (at
    least one A entry a chunk); the chunks' unique entries merge by one
    more sort and compress. A's entries go in CSC order where A has its
    CSC (k ascending: B's rows are read in order), else in CSR order. The
    ESC walks B's rows, so it needs B's CSR (B's CSC with transpose_b);
    the JAX package recurses through transposes without end there, and
    this raises."""
    if transpose_b:
        b_ptr, b_ind, b_val = B.col_ptr, B.csc_row_ind, B.csc_val
        k_dim, out_ncols = B.ncols, B.nrows
    else:
        b_ptr, b_ind, b_val = B.row_ptr, B.col_ind, B.val
        k_dim, out_ncols = B.nrows, B.ncols
    if A.ncols != k_dim:
        raise ValueError(f"dim mismatch: A is {A.shape}, B k-dim {k_dim}")
    if b_ptr is None:
        raise ValueError("the ESC SpGEMM walks B's rows: it needs B's CSR, "
                         "or B's CSC with transpose_b")
    if A.col_ptr is not None:
        ai, ak, av, a_sorted = (A.csc_row_ind, A.csc_col_ind, A.csc_val,
                                True)
    else:
        ai, ak, av, a_sorted = A.row_ind, A.col_ind, A.val, False
    # The call's host reads: B's row pointers and A's k ids (esc_plan),
    # each chunk's unique count and the merge's below, and the result's
    # symmetry test (Matrix.from_device_coo).
    csum, bounds = esc_plan(A, B, transpose_b, max_lanes)
    if csum[-1] == 0:
        return Matrix.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0), A.nrows, out_ncols,
                               dtype=A.dtype, device=A.device)
    pieces = []
    for s, t in zip(bounds[:-1], bounds[1:]):
        lanes = max(round_up(int(csum[t] - csum[s]), 1024), 1024)
        ci, cj, cv, nu = _esc_chunk(ai[s:t], ak[s:t], av[s:t], b_ptr, b_ind,
                                    b_val, lanes, semiring, a_sorted,
                                    out_ncols)
        nu = int(nu)
        pieces.append((ci[:nu], cj[:nu], cv[:nu]))
    if len(pieces) == 1:
        ci, cj, cv = pieces[0]
    else:
        ci, cj, cv, nu = _merge_coo(
            *(torch.cat([p[x] for p in pieces]) for x in range(3)),
            semiring, out_ncols)
        nu = int(nu)
        ci, cj, cv = ci[:nu], cj[:nu], cv[:nu]
    return Matrix.from_device_coo(ci, cj, cv, A.nrows, out_ncols,
                                  dtype=A.dtype)


def _merge_coo(i: torch.Tensor, j: torch.Tensor, v: torch.Tensor,
               semiring: Semiring, ncols: int):
    """The cross-chunk merge: the chunks' unique entries, concatenated, with
    the same (i, j) from several chunks ⊕-combined (`_sort_dedup_coo`)."""
    return _sort_dedup_coo(i, j, v, semiring.add, ncols)


def esc_plan(A: Matrix, B: Matrix, transpose_b: bool = False,
             max_lanes: int = 1 << 23) -> tuple:
    """(csum, bounds) of `spgemm_esc(A, B, ...)`'s host sizing: csum the
    int64 prefix sums of the products of A's entries in ESC order (csum[-1]
    the expansion's size), and the greedy chunks of A entries
    bounds[c]..bounds[c + 1], each expanding to at most max_lanes lanes
    (at least one entry a chunk), found by a searchsorted over csum. Reads
    B's row pointers and A's k ids on the host."""
    b_ptr = B.col_ptr if transpose_b else B.row_ptr
    ak = A.csc_col_ind if A.col_ptr is not None else A.col_ind
    b_ptr_np = b_ptr.cpu().numpy().astype(np.int64)
    ak_np = np.minimum(ak[:A.nvals].cpu().numpy(), b_ptr_np.shape[0] - 2)
    deg = b_ptr_np[ak_np + 1] - b_ptr_np[ak_np]
    csum = np.concatenate([[0], np.cumsum(deg)])
    max_lanes = max(max_lanes, int(deg.max(initial=0)))
    bounds = [0]
    while bounds[-1] < A.nvals:
        s = bounds[-1]
        t = int(np.searchsorted(csum, csum[s] + max_lanes, side="right")) - 1
        bounds.append(min(max(t, s + 1), A.nvals))
    return csum, bounds


# rows of a dense semiring product's (rows, k, n) block: at most this many
# products at a time
DENSE_BLOCK = 1 << 24


def _dense_semiring_product(Ad: torch.Tensor, Bd: torch.Tensor,
                            semiring: Semiring) -> torch.Tensor:
    """C[i, j] = ⊕_k Ad[i, k] ⊗ Bd[k, j] over every k, stored or not (the
    absent entries are 0), as JAX's broadcast and lax.reduce compute it:
    in blocks of rows, so that a (rows, k, n) block of products holds at
    most DENSE_BLOCK."""
    k, n = Bd.shape
    rows = max(1, DENSE_BLOCK // max(k * n, 1))
    blocks = [reduce_dim(semiring.mul(Ad[r:r + rows, :, None], Bd[None]),
                         semiring.add, 1)
              for r in range(0, Ad.shape[0], rows)]
    return (torch.cat(blocks) if blocks
            else torch.zeros(0, n, dtype=Ad.dtype, device=Ad.device))


def spgemm(A: Matrix, B: Matrix, semiring: Semiring,
           transpose_b: bool = False,
           dense_limit: int = 1024 * 1024) -> Matrix:
    """Unmasked C = A ⊕.⊗ B (reference: cusparse_spgemm2,
    spgemm.hpp:282-508, float plus-times only; this is any semiring). An
    output of at most `dense_limit` entries is a dense product over the
    host's dense images, built back with `Matrix.from_dense` (its CSRCSC
    format, zeros dropped), as the JAX package builds it: PlusMultiplies by
    torch.matmul in float32 (the product outside any kernel, as JAX's
    jnp.dot), any other semiring by `_dense_semiring_product`. A larger
    output takes the ESC (`spgemm_esc`)."""
    eff_ncols = B.nrows if transpose_b else B.ncols
    k_dim = B.ncols if transpose_b else B.nrows
    if A.ncols != k_dim:
        raise ValueError(f"dim mismatch: A is {A.shape}, B k-dim {k_dim}")
    if A.nrows * eff_ncols > dense_limit:
        return spgemm_esc(A, B, semiring, transpose_b=transpose_b)
    Ad = torch.from_numpy(A.to_dense()).to(A.device)
    Bd = torch.from_numpy(B.to_dense()).to(A.device)
    if transpose_b:
        Bd = Bd.T
    if semiring.name == "PlusMultiplies":
        Cd = torch.matmul(Ad.float(), Bd.float()).to(A.dtype)
    else:
        Cd = _dense_semiring_product(Ad, Bd, semiring)
    return Matrix.from_dense(Cd, device=A.device)
