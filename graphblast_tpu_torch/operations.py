"""The public GraphBLAS operations, Vector and Matrix level, functional
(counterpart of graphblast_tpu/operations.py; reference:
graphblas/operations.hpp:22-886): results are returned, never written into
an argument. The argument order keeps (mask, accum, op, inputs, desc)
recognisable, and the dimension checks of dimension.hpp:13-114 run before
any device work.

The surface:
  - mxv, vxm and apply_vxm, with masks, accumulators and descriptors: a
    sparse u pushes (`ops/spmspv.spmspv_push`, its gathers on K6), a dense
    u pulls (`ops/spmv.spmv_pull`: K5 + K6 for a structure-only
    LogicalOrAnd, the row fold S for a min/max ⊕, else K6 and a segmented
    reduce), and a one-sided Matrix forces its one direction. Fused loops
    use `ops/dispatch.mxv_dual` instead;
  - eWiseMult, eWiseAdd, apply, assign, assign_indexed, reduce_vector,
    reduce_matrix, reduce_matrix_to_vector, scatter, assign_scatter,
    extract_gather, extract and scale_vector, on tensors
    (`ops/elementwise.py`, `ops/segops.reduce_all`);
  - mxm: masked on T1/T2 (`ops/spgemm.spgemm_masked`), unmasked by ESC or,
    for a small output, densely (`ops/spgemm.spgemm`); mxm_dense, a sparse
    times a dense matrix (`ops/spmm.py`);
  - the matrix construction ops, built on the host as the JAX package
    builds them: apply_matrix on its "cpu" backend, extract_matrix,
    extract_col, the assign_matrix family and eWiseAdd_matrix; and
    eWiseMult_matrix_scalar, scale_matrix, scale_matrix_rows,
    scale_matrix_cols, apply_matrix, transpose, tril and
    trace_mxm_transpose, on A's device.
A result lives on its operands' device.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import dimension as dim
from .dense_matrix import DenseMatrix
from .descriptor import DEFAULT, Descriptor
from .matrix import Matrix, _numpy_dtype
from .ops import elementwise as ew
from .ops import spgemm
from .ops.gather_dispatch import take
from .ops.kernels.minmax_pull import minmax_supported
from .ops.kernels.row_schedule import schedule_for
from .ops.segops import reduce_all
from .ops.spmm import spmm
from .ops.spmspv import spmspv_push
from .ops.spmv import mask_pass, spmv_pull
from .semiring import BinaryOp, Monoid, Semiring, extract_add, extract_mul
from .types import INDEX_DTYPE, Direction, SparseFormat, Storage, round_up
from .vector import Vector, to_tensor


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)   # reference: Info error codes, types.hpp:28-42


def _mask_dense(mask: Optional[Vector], ident=0):
    if mask is None:
        return None
    return mask.to_dense(ident).dense


def _edge_cap(A: Matrix, desc: Descriptor) -> int:
    """The push's expansion lanes: memusage · nnz_pad, at least 128, in
    128s, and at most nnz_pad while memusage <= 1 (the JAX package's
    `_edge_cap`; reference: spmspv_inner.hpp:51-59)."""
    cap = int(round_up(max(int(A.nnz_pad * desc.memusage), 128), 128))
    return min(cap, A.nnz_pad) if desc.memusage <= 1.0 else cap


def _apply_accum(old_dense, new_dense, accum):
    """w = accum(w_old, t) elementwise, of t's dtype; t alone without an
    accumulator or without w (reference: spmv.hpp:213-220)."""
    if accum is None or old_dense is None:
        return new_dense
    op = accum.op if isinstance(accum, Monoid) else accum
    return op(old_dense, new_dense).to(new_dense.dtype)


def _debug_op(desc: Descriptor, name: str, **operands):
    """The op's banner and its operands and descriptor, under desc.debug
    (reference: `===Begin vxm===`, backend/cuda/operations.hpp:91-94, and
    printState, backend/cuda/util.hpp:67-74)."""
    if not desc.debug:
        return
    print(f"===Begin {name}===")
    print(f"  scmp={desc.mask_scmp} replace={desc.output_replace} "
          f"tran0={desc.transpose_inp0} tran1={desc.transpose_inp1} "
          f"mxvmode={desc.mxv_mode.name} struconly={desc.structure_only}")
    for k, v in operands.items():
        if v is not None:
            print(f"  {k}: {v!r}")


# ---------------------------------------------------------------------------
# mxv / vxm (reference: operations.hpp:59-127 → backend 82-327)
# ---------------------------------------------------------------------------


def mxv(A: Matrix, u: Vector, semiring: Semiring,
        mask: Optional[Vector] = None, accum=None,
        desc: Descriptor = DEFAULT, w: Optional[Vector] = None) -> Vector:
    """w = A ⊕.⊗ u (reference: operations.hpp:97-127)."""
    return _matvec(A, u, semiring, mask, accum, desc, w,
                   transpose=desc.transpose_inp0)


def vxm(u: Vector, A: Matrix, semiring: Semiring,
        mask: Optional[Vector] = None, accum=None,
        desc: Descriptor = DEFAULT, w: Optional[Vector] = None) -> Vector:
    """w = u ⊕.⊗ A = Aᵀ ⊕.⊗ u (reference: operations.hpp:59-87, which
    toggles GrB_INP1 and calls mxv)."""
    return _matvec(A, u, semiring, mask, accum, desc, w,
                   transpose=not desc.transpose_inp1)


def _matvec(A, u, semiring, mask, accum, desc, w, transpose: bool) -> Vector:
    """One product over A's pull or push orientation, chosen by u's
    storage: a sparse u pushes (out sparse), a dense u pulls (out dense),
    and a Matrix with one orientation forces its direction; PUSHONLY and
    PULLONLY force theirs. The density heuristic of PUSHPULL lives in
    `mxv_dual`, for the fused loops."""
    op_name = "vxm" if transpose else "mxv"
    _debug_op(desc, op_name, A=A, u=u, mask=mask)
    n_out = A.ncols if transpose else A.nrows
    if transpose:
        dim.check_row_size(A, u, op_name)
        dim.check_col_size(A, mask, op_name, "mask")
        dim.check_col_size(A, w, op_name, "w")
    else:
        dim.check_col_size(A, u, op_name)
        dim.check_row_size(A, mask, op_name, "mask")
        dim.check_row_size(A, w, op_name, "w")
    ident = semiring.identity(u.dtype).item()
    mask_d = _mask_dense(mask)

    mode = desc.mxv_mode
    if mode == Direction.PUSHPULL:
        mode = (Direction.PUSHONLY if u.storage == Storage.SPARSE
                else Direction.PULLONLY)
    pull = A.pull_csr(transpose)[2:]
    push = A.pull_csr(not transpose)[2:]
    if push[0] is None:
        mode = Direction.PULLONLY
    if pull[0] is None:
        mode = Direction.PUSHONLY

    if mode == Direction.PUSHONLY:
        us = u.to_sparse(ident)
        y = spmspv_push(push[0], push[1], push[2], us.sind, us.sval,
                        us.snvals, semiring, n_out, _edge_cap(A, desc),
                        mask_d, desc.mask_scmp, desc.structure_only,
                        desc.sort_push, out_dtype=u.dtype)
    else:
        ud = u.to_dense(ident).dense
        # the min/max row fold S reads the orientation's row schedule
        sched = (schedule_for(A, transpose)
                 if minmax_supported(semiring, ud.dtype) else None)
        y = spmv_pull(pull[0], pull[1], pull[2], ud, semiring, n_out,
                      mask_d, desc.mask_scmp, desc.structure_only,
                      sched=sched)
    y = _apply_accum(w.to_dense(ident).dense if w is not None else None, y,
                     accum)
    out = Vector(n_out, Storage.DENSE, dense=y)
    return out.to_sparse(ident) if mode == Direction.PUSHONLY else out


def apply_vxm(u: Vector, A: Matrix, semiring: Semiring,
              mask: Optional[Vector] = None, accum=None,
              desc: Descriptor = DEFAULT,
              w: Optional[Vector] = None) -> Vector:
    """The fused apply and vector-matrix product: wᵀ = wᵀ accum maskᵀ .*
    (uᵀ ⊕.⊗ A) (reference: operations.hpp:830-865 →
    backend/cuda/operations.hpp:1275-1404; LGC's residual update,
    lgc.hpp:121-127). The reference needs its own entry point because its
    vxm cannot carry an accumulator; here it is vxm's semantics."""
    return vxm(u, A, semiring, mask=mask, accum=accum, desc=desc, w=w)


# ---------------------------------------------------------------------------
# mxm (reference: operations.hpp:22-49 → backend 18-78); ops/spgemm.py
# ---------------------------------------------------------------------------


def mxm(A: Matrix, B: Matrix, semiring: Semiring,
        mask: Optional[Matrix] = None, accum=None,
        desc: Descriptor = DEFAULT) -> Matrix:
    """C = A ⊕.⊗ B, sparse × sparse. With a mask, C has the mask's
    structure (reference: spgemm.hpp:85-87) and T2 computes it; without,
    `spgemm.spgemm` (ESC, or dense for a small output). desc.transpose_inp1
    takes Bᵀ (TC's idiom, tc.hpp:24). `accum` is accepted and not read, as
    in the JAX package."""
    _debug_op(desc, "mxm", A=A, B=B, mask=mask)
    b_inner = B.ncols if desc.transpose_inp1 else B.nrows
    if A.ncols != b_inner:
        raise dim.DimensionException(
            f"mxm: dimension mismatch — A is {A.shape}, "
            f"B{'ᵀ' if desc.transpose_inp1 else ''} inner dim {b_inner}")
    if mask is not None:
        dim.check_row_row(A, mask, "mxm")
        return spgemm.spgemm_masked(A, B, mask, semiring,
                                    transpose_b=desc.transpose_inp1)
    return spgemm.spgemm(A, B, semiring, transpose_b=desc.transpose_inp1)


def mxm_dense(A: Matrix, B, semiring: Semiring,
              desc: Descriptor = DEFAULT) -> torch.Tensor:
    """C = A ⊕.⊗ B with a dense B (A's ncols, k): a (nrows, k) tensor of
    B's dtype on A's device (`ops/spmm.py`; reference: spmm.hpp:16-40
    declares it). B is a DenseMatrix, a tensor or an array;
    desc.transpose_inp0 takes Aᵀ, over the CSC."""
    if isinstance(B, DenseMatrix):
        B = B.data
    B = to_tensor(B, device=A.device)
    _check(B.dim() == 2 and B.shape[0] == A.ncols,
           f"dim mismatch: B {tuple(B.shape)} vs A.ncols={A.ncols}")
    if desc.transpose_inp0:
        return spmm(A.col_ptr, A.csc_row_ind, A.csc_val, B, semiring,
                    A.ncols, row_ind=A.csc_col_ind)
    return spmm(A.row_ptr, A.col_ind, A.val, B, semiring, A.nrows,
                row_ind=A.row_ind)


# ---------------------------------------------------------------------------
# eWiseMult / eWiseAdd (reference: operations.hpp:137-353)
# ---------------------------------------------------------------------------


def _binop_of(op, use_mul: bool) -> BinaryOp:
    if isinstance(op, Semiring):
        return extract_mul(op) if use_mul else extract_add(op).op
    if isinstance(op, Monoid):
        return op.op
    return op


def eWiseMult(u: Vector, v: Union[Vector, float, int], op,
              mask: Optional[Vector] = None, accum=None,
              desc: Descriptor = DEFAULT,
              w: Optional[Vector] = None) -> Vector:
    """w = u ⊗ v elementwise (reference: operations.hpp:137-267, the
    semiring's ⊗). Dense out, sparse operands densified with identity 0,
    but for sparse ∘ dense with no mask, accumulator or semiring, which
    keeps u's stored indices (ewisemult.hpp:174-270): one gather of v at
    them.

    The reference's quirks kept, as the JAX package keeps them: with a
    Semiring `op`, an entry where either operand equals ⊕'s identity is
    the identity (eWiseMultKernel's annihilator, kernels/ewisemult.hpp:
    22-23, which keeps LGC's PlusDivides off zero degrees), unmasked only;
    and the mask's scmp is ignored (kernels/ewisemult.hpp:31)."""
    ann = op.identity(u.dtype).item() if isinstance(op, Semiring) else None
    if desc.mask_scmp:
        desc = desc.replace(mask_scmp=False)
    if (isinstance(v, Vector) and u.storage == Storage.SPARSE
            and v.storage == Storage.DENSE and mask is None and accum is None
            and w is None and ann is None):
        dim.check_size_size(u, v, "eWiseMult")
        binop = _binop_of(op, use_mul=True)
        vi = take(v.dense, u.sind.clamp(max=u.n - 1), sorted=True)
        live = (torch.arange(u.cap, dtype=INDEX_DTYPE, device=u.sind.device)
                < u.snvals)
        sval = torch.where(live, binop(u.sval, vi.to(u.sval.dtype)),
                           torch.zeros((), dtype=u.sval.dtype,
                                       device=u.sval.device))
        return Vector(u.n, Storage.SPARSE, sind=u.sind, sval=sval,
                      snvals=u.snvals)
    return _ewise(u, v, _binop_of(op, use_mul=True), mask, accum, desc, w,
                  annihilator=ann)


def eWiseAdd(u: Vector, v: Union[Vector, float, int], op,
             mask: Optional[Vector] = None, accum=None,
             desc: Descriptor = DEFAULT,
             w: Optional[Vector] = None) -> Vector:
    """w = u ⊕ v elementwise (reference: operations.hpp:277-353, the
    semiring's ⊕); the output is always dense (backend ewiseadd.hpp)."""
    return _ewise(u, v, _binop_of(op, use_mul=False), mask, accum, desc, w)


def _ewise(u, v, binop, mask, accum, desc, w, annihilator=None) -> Vector:
    _debug_op(desc, "eWise", u=u, v=v, mask=mask)
    mask_d = _mask_dense(mask)
    if mask is not None:
        dim.check_size_size(u, mask, "eWise", "u/mask")
    if isinstance(v, Vector):
        dim.check_size_size(u, v, "eWise")
        if u.storage == Storage.SPARSE and v.storage == Storage.DENSE:
            out = ew.ewise_add_sparse_dense(u.n, u.sind, u.sval, u.snvals,
                                            v.dense, binop)
            if mask_d is not None:
                out = torch.where(mask_pass(mask_d, desc.mask_scmp), out,
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device))
        else:
            ud = u.to_dense(0).dense
            vd = v.to_dense(0).dense
            out = ew.ewise_binary_dense(ud, vd, binop, 0, mask_d,
                                        desc.mask_scmp)
            if annihilator is not None and mask_d is None:
                # only the unmasked kernel annihilates
                # (kernels/ewisemult.hpp:22-23 against :50-53)
                ann = ew.scalar_like(annihilator, ud)
                out = torch.where((ud == ann) | (vd.to(ud.dtype) == ann),
                                  ann, out)
    else:
        ud = u.to_dense(0).dense
        out = ew.ewise_binary_dense(ud, v, binop, 0, mask_d, desc.mask_scmp)
        if annihilator is not None and mask_d is None:
            ann = ew.scalar_like(annihilator, ud)
            out = torch.where((ud == ann) | (ew.scalar_like(v, ud) == ann),
                              ann, out)
    out = _apply_accum(w.to_dense(0).dense if w is not None else None, out,
                       accum)
    return Vector(u.n, Storage.DENSE, dense=out)


# ---------------------------------------------------------------------------
# apply (reference: operations.hpp:560-610)
# ---------------------------------------------------------------------------


def apply(u: Vector, fn, mask: Optional[Vector] = None,
          desc: Descriptor = DEFAULT) -> Vector:
    """w = fn(u) elementwise, fn on tensors; where the mask fails, u's old
    value. desc.backend == "cpu" applies fn to one Python number at a time
    on the host instead (the reference's GrB_BACKEND=GrB_SEQUENTIAL toggle,
    mis.hpp:131-133), for stateful functors."""
    ud = u.to_dense(0).dense
    mask_d = _mask_dense(mask)
    if desc.backend == "cpu":
        out = torch.as_tensor(np.asarray(
            [fn(x) for x in ud.cpu().numpy()])).to(ud.device)
        if mask_d is not None:
            out = torch.where(mask_pass(mask_d, desc.mask_scmp), out, ud)
        return Vector(u.n, Storage.DENSE, dense=out)
    return Vector(u.n, Storage.DENSE, dense=ew.apply_unary_dense(
        ud, fn, mask_d, desc.mask_scmp))


def apply_matrix(A: Matrix, fn, desc: Descriptor = DEFAULT) -> Matrix:
    """A' = fn(A) over the stored values (reference: matrix apply with host
    functors, backend/cuda/apply.hpp:102-111). By default fn maps the value
    tensors on A's device, the padded slots kept as they are (fn(0) may be
    nonzero); desc.backend == "cpu" applies fn to one Python number at a
    time over the host's values (the reference's semantics, for stateful
    functors: keep it to preprocessing-sized matrices), the CSC's in its
    own order."""
    if A.val is None:
        return A
    if desc.backend == "cpu":
        def host_apply(host, template):
            vh = host[2][: A.nvals]
            new = np.asarray([fn(x) for x in vh], dtype=vh.dtype)
            out = torch.zeros_like(template, device="cpu")
            out[: len(new)] = torch.from_numpy(new)
            return out.to(template.device), (host[0], host[1], new)

        new_val, host_csr = host_apply(A.host_csr(), A.val)
        new_csc, host_csc = ((None, None) if A.csc_val is None
                             else host_apply(A.host_csc(), A.csc_val))
        return Matrix(A.nrows, A.ncols, A.nvals, A.row_ptr, A.col_ind,
                      A.row_ind, new_val, A.col_ptr, A.csc_row_ind,
                      A.csc_col_ind, new_csc, format=A.format,
                      symmetric=A.symmetric, _host_csr=host_csr,
                      _host_csc=host_csc)

    def dev_apply(v, r, c):
        live = torch.arange(v.shape[0], device=v.device) < A.nvals
        return torch.where(live, fn(v), v)

    return _scale_vals(A, dev_apply, breaks_symmetry=False)


# ---------------------------------------------------------------------------
# assign (reference: operations.hpp:509-530 → backend 822-860)
# ---------------------------------------------------------------------------


def assign(w: Vector, value, mask: Optional[Vector] = None,
           desc: Descriptor = DEFAULT) -> Vector:
    """Masked constant assign over all indices (GrB_ALL). A dense w keeps
    its old values where the mask fails, unless desc.output_replace
    (GrB_REPLACE): then they are cleared to 0. A sparse w sets, then
    prunes the entries equal to the value (SSSP's filter,
    assign.hpp:107-245)."""
    _debug_op(desc, "assign", w=w, mask=mask)
    dim.check_size_size(w, mask, "assign", "w/mask")
    mask_d = _mask_dense(mask)
    if w.storage == Storage.SPARSE:
        sind, sval, nv = ew.assign_constant_sparse(
            w.n, w.sind, w.sval, w.snvals, value, mask_d, desc.mask_scmp)
        return Vector(w.n, Storage.SPARSE, sind=sind, sval=sval, snvals=nv)
    base = torch.zeros_like(w.dense) if desc.output_replace else w.dense
    return Vector(w.n, Storage.DENSE, dense=ew.assign_constant_dense(
        base, value, mask_d, desc.mask_scmp))


def assign_indexed(w: Vector, u: Vector, indices,
                   desc: Descriptor = DEFAULT) -> Vector:
    """w[indices[i]] = u[i] for host indices (reference: assignIndexed,
    operations.hpp:419-439)."""
    wd = w.to_dense(0).dense
    ud = u.to_dense(0).dense
    idx = torch.as_tensor(np.asarray(indices), dtype=INDEX_DTYPE).to(
        wd.device)
    return Vector(w.n, Storage.DENSE, dense=ew.scatter_indexed(
        wd, ud[: idx.shape[0]], idx))


# ---------------------------------------------------------------------------
# reduce (reference: operations.hpp:620-673)
# ---------------------------------------------------------------------------


def reduce_vector(u: Vector, monoid: Monoid,
                  desc: Descriptor = DEFAULT) -> torch.Tensor:
    """vector → scalar, a 0-d tensor; structure_only on a sparse u gives
    its count (reference: reduce.hpp:71-75)."""
    _debug_op(desc, "reduce", u=u)
    if u.storage == Storage.SPARSE:
        return ew.reduce_sparse_vector(u.sval, u.snvals, monoid,
                                       desc.structure_only)
    return ew.reduce_dense_vector(u.dense, monoid)


def reduce_matrix_to_vector(A: Matrix, monoid: Monoid,
                            desc: Descriptor = DEFAULT) -> Vector:
    """matrix → vector row reduce (reference: operations.hpp:620-641;
    PageRank's out-degrees, LGC's degrees): the monoid over each row's
    stored values, its identity on empty rows, for every monoid
    (`elementwise.reduce_matrix_rows`)."""
    if A.row_ptr is None:
        raise ValueError("reduce_matrix_to_vector needs A's CSR")
    return Vector(A.nrows, Storage.DENSE, dense=ew.reduce_matrix_rows(
        A.row_ptr, A.val, monoid, A.nrows))


def reduce_matrix(A: Matrix, monoid: Monoid,
                  desc: Descriptor = DEFAULT) -> torch.Tensor:
    """matrix → scalar, a 0-d tensor (reference: operations.hpp:651-673;
    TC's final count): over all nnz_pad slots, the padded ones holding
    the identity, as in the JAX package."""
    valid = torch.arange(A.nnz_pad, device=A.val.device) < A.nvals
    return reduce_all(torch.where(
        valid, A.val, monoid.identity(A.val.dtype).item()), monoid)


# ---------------------------------------------------------------------------
# scatter / assignScatter / extractGather (reference: operations.hpp:749-814,
# CC's pointer-chasing primitives)
# ---------------------------------------------------------------------------


def scatter(w: Vector, indices: Vector, value,
            desc: Descriptor = DEFAULT) -> Vector:
    """w[indices[i]] = value (reference: operations.hpp:749-761); a sparse
    `indices` gives its stored ids, and its pads (id n) are dropped."""
    wd = w.to_dense(0).dense
    idx = (indices.sind if indices.storage == Storage.SPARSE
           else indices.dense.to(INDEX_DTYPE))
    return Vector(w.n, Storage.DENSE,
                  dense=ew.scatter_constant(wd, value, idx))


def assign_scatter(w: Vector, u: Vector, indices: Vector,
                   desc: Descriptor = DEFAULT) -> Vector:
    """w[indices[i]] = u[i] (reference: operations.hpp:771-790 →
    scatterIndexed; CC's hooking, parent[parent_temp[i]] = mnp[i])."""
    dim.check_size_size(u, indices, "assignScatter", "u/indices")
    wd = w.to_dense(0).dense
    ud = u.to_dense(0).dense
    idx = indices.to_dense(0).dense.to(INDEX_DTYPE)
    return Vector(w.n, Storage.DENSE, dense=ew.scatter_indexed(wd, ud, idx))


def extract_gather(u: Vector, indices: Vector,
                   desc: Descriptor = DEFAULT) -> Vector:
    """w[i] = u[indices[i]] (reference: operations.hpp:800-814 →
    gatherIndexed; CC's grandparent step)."""
    ud = u.to_dense(0).dense
    idx = indices.to_dense(0).dense.to(INDEX_DTYPE)
    return Vector(u.n, Storage.DENSE, dense=ew.gather_indexed(ud, idx))


# ---------------------------------------------------------------------------
# extract (reference: operations.hpp:355-410, all three NOT_IMPLEMENTED
# stubs there)
# ---------------------------------------------------------------------------


def _host_indices(indices, bound: int, what: str) -> np.ndarray:
    idx = np.asarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= bound):
        raise dim.DimensionException(
            f"{what}: index out of bounds (valid range [0, {bound}))")
    return idx


def extract(u: Vector, indices=None, mask: Optional[Vector] = None,
            accum=None, desc: Descriptor = DEFAULT,
            w: Optional[Vector] = None) -> Vector:
    """w = w ⊕? mask .* u[indices], a subvector (reference:
    operations.hpp:355-371). `indices` is a host index list (None is
    GrB_ALL). With `accum` and `w` the selected lanes combine into w; where
    the mask fails, w's value (0 without w)."""
    _debug_op(desc, "extract", u=u, mask=mask)
    ud = u.to_dense(0).dense
    if indices is None:
        out, n_out = ud, u.n
    else:
        idx = _host_indices(indices, u.n, "extract")
        n_out = int(idx.size)
        out = ud[torch.from_numpy(idx).to(ud.device)]
    if mask is not None and mask.n != n_out:
        raise dim.DimensionException(
            f"extract: mask size {mask.n} != output size {n_out}")
    if w is not None and w.n != n_out:
        raise dim.DimensionException(
            f"extract: w size {w.n} != output size {n_out}")
    mask_d = _mask_dense(mask)
    base = (w.to_dense(0).dense if w is not None
            else torch.zeros(n_out, dtype=out.dtype, device=out.device))
    if accum is not None:
        out = _binop_of(accum, use_mul=False)(base, out)
    if mask_d is not None:
        out = torch.where(mask_pass(mask_d, desc.mask_scmp), out, base)
    return Vector(n_out, Storage.DENSE, dense=out)


def extract_matrix(A: Matrix, row_indices=None, col_indices=None,
                   mask: Optional[Matrix] = None,
                   desc: Descriptor = DEFAULT) -> Matrix:
    """C = mask .* A[row_indices, col_indices], a submatrix (reference:
    operations.hpp:373-391). Index lists are host arrays (None is
    GrB_ALL); a repeated index repeats its row or column. Built on the
    host from A's entries (`from_coo`, A's format, on A's device)."""
    ri, ci, v = A.extract_tuples()
    if row_indices is None:
        row_sel, nrows_out = None, A.nrows
    else:
        row_sel = _host_indices(row_indices, A.nrows, "extract_matrix rows")
        nrows_out = int(row_sel.size)
    if col_indices is None:
        col_sel, ncols_out = None, A.ncols
    else:
        col_sel = _host_indices(col_indices, A.ncols, "extract_matrix cols")
        ncols_out = int(col_sel.size)

    if row_sel is None:
        out_r, out_c_src, out_v_src = ri, ci, v
    else:
        # occurrence k of row_sel takes all of A's row row_sel[k]
        ptr = np.concatenate([[0], np.cumsum(np.bincount(
            ri, minlength=A.nrows))])
        deg = ptr[row_sel + 1] - ptr[row_sel]
        out_r = np.repeat(np.arange(nrows_out, dtype=np.int64), deg)
        slots = (np.repeat(ptr[row_sel] - np.cumsum(deg) + deg, deg)
                 + np.arange(deg.sum()))
        out_c_src, out_v_src = ci[slots], v[slots]
    if col_sel is None:
        out_c, out_rr, out_vv = out_c_src, out_r, out_v_src
    else:
        # a source column may sit at several output positions: a sorted
        # membership join
        order = np.argsort(col_sel, kind="stable")
        cs_sorted = col_sel[order]
        lo = np.searchsorted(cs_sorted, out_c_src, side="left")
        reps = np.searchsorted(cs_sorted, out_c_src, side="right") - lo
        out_rr = np.repeat(out_r, reps)
        out_vv = np.repeat(out_v_src, reps)
        pos = np.repeat(lo, reps) + (np.arange(reps.sum()) - np.repeat(
            np.cumsum(reps) - reps, reps))
        out_c = order[pos]
    if mask is not None:
        if (mask.nrows, mask.ncols) != (nrows_out, ncols_out):
            raise dim.DimensionException(
                f"extract_matrix: mask {mask.shape} != output "
                f"({nrows_out}, {ncols_out})")
        inmask = _in_sorted(_mask_keys(mask), out_rr * ncols_out + out_c)
        out_rr, out_c, out_vv = out_rr[inmask], out_c[inmask], out_vv[inmask]
    return Matrix.from_coo(out_rr, out_c, out_vv, nrows_out, ncols_out,
                           dtype=A.dtype, fmt=A.format, device=A.device)


def extract_col(A: Matrix, row_indices, col_index: int,
                mask: Optional[Vector] = None, accum=None,
                desc: Descriptor = DEFAULT,
                w: Optional[Vector] = None) -> Vector:
    """w = w ⊕? mask .* A[row_indices, col_index], a column (reference:
    operations.hpp:393-410), from the CSC's column on the host."""
    if not 0 <= col_index < A.ncols:
        raise dim.DimensionException(
            f"extract_col: col {col_index} out of range [0, {A.ncols})")
    host = A.host_csc()
    if host is None:
        raise ValueError("extract_col needs the CSC orientation "
                         "(GRB_SPARSE_MATRIX_FORMAT includes CSC)")
    cptr, rix, cval = host
    s, e = int(cptr[col_index]), int(cptr[col_index + 1])
    col = np.zeros(A.nrows, cval.dtype)
    col[rix[s:e]] = cval[s:e]
    sel = (np.arange(A.nrows, dtype=np.int64) if row_indices is None
           else _host_indices(row_indices, A.nrows, "extract_col"))
    return extract(Vector.dense_from(col, device=A.device), sel, mask=mask,
                   accum=accum, desc=desc, w=w)


# ---------------------------------------------------------------------------
# matrix assign and matrix eWiseAdd (reference: operations.hpp:300-318 and
# 440-552, NOT_IMPLEMENTED stubs there): construction ops on the host
# ---------------------------------------------------------------------------


def _mask_keys(mask: Matrix) -> np.ndarray:
    mr, mc, _ = mask.extract_tuples()
    return np.sort(mr * mask.ncols + mc)


def _in_sorted(keys_sorted: np.ndarray, q: np.ndarray) -> np.ndarray:
    if not keys_sorted.size:
        return np.zeros(q.shape, bool)
    p = np.searchsorted(keys_sorted, q)
    return (p < keys_sorted.size) & (
        keys_sorted[np.minimum(p, keys_sorted.size - 1)] == q)


def _dedupe_coo(keys: np.ndarray, vals, combine=None):
    """Combine duplicate keys; returns sorted keys and their values.
    `from_coo` stores raw COO (a duplicate slot is a legal stored entry), so
    the construction ops normalise first. combine=None keeps the LAST
    occurrence (to_dense's write order); otherwise duplicates fold with
    `combine` pairwise, in log passes (combine must be associative), as in
    the JAX package."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], np.asarray(vals)[order]
    while ks.size:
        head = np.r_[True, ks[1:] != ks[:-1]]
        if head.all():
            break
        idx = np.arange(ks.size)
        run = idx - np.maximum.accumulate(np.where(head, idx, -1))
        odd = (run & 1) == 1
        tgt = np.flatnonzero(odd) - 1
        vs = vs.copy()
        if combine is None:
            vs[tgt] = vs[tgt + 1]
        else:
            vs[tgt] = np.asarray(combine(torch.from_numpy(vs[tgt]),
                                         torch.from_numpy(vs[tgt + 1])),
                                 dtype=vs.dtype)
        ks, vs = ks[~odd], vs[~odd]
    return ks, vs


def _sel_or_all(indices, bound: int, what: str) -> np.ndarray:
    if indices is None:
        return np.arange(bound, dtype=np.int64)
    sel = _host_indices(indices, bound, what)
    if np.unique(sel).size != sel.size:
        raise ValueError(f"{what}: duplicate indices are undefined for "
                         "assign (GraphBLAS 4.3.7)")
    return sel


def _assign_entries(C: Matrix, tr, tc, tv, accum) -> Matrix:
    """The core subassign: the target entries (tr, tc, tv) land in C,
    overwriting C's entries there (no accum) or combining with them
    (accum); C's other entries stay (subassign without REPLACE). Keeps C's
    dtype and format."""
    cr, cc, cv = C.extract_tuples()
    key_c, cv = _dedupe_coo(cr * C.ncols + cc, cv)       # the last wins,
    key_ts, tv = _dedupe_coo(tr * C.ncols + tc, tv)      # as in to_dense
    hit = _in_sorted(key_ts, key_c)
    if accum is not None and hit.any():
        binop = _binop_of(accum, use_mul=False)
        p = np.searchsorted(key_ts, key_c[hit])
        tv = tv.copy()
        tv[p] = np.asarray(binop(torch.from_numpy(cv[hit].astype(tv.dtype)),
                                 torch.from_numpy(tv[p])), dtype=tv.dtype)
    out_k = np.concatenate([key_c[~hit], key_ts])
    out_v = np.concatenate([cv[~hit], tv.astype(cv.dtype)])
    return Matrix.from_coo(out_k // C.ncols, out_k % C.ncols, out_v,
                           C.nrows, C.ncols, dtype=C.dtype, fmt=C.format,
                           device=C.device)


def assign_matrix(C: Matrix, A: Matrix, row_indices=None, col_indices=None,
                  mask: Optional[Matrix] = None, accum=None,
                  desc: Descriptor = DEFAULT) -> Matrix:
    """C[row_indices, col_indices] ⊕?= mask .* A (reference:
    operations.hpp:440-460). A is (len(row_indices), len(col_indices));
    the mask has A's shape."""
    ri_sel = _sel_or_all(row_indices, C.nrows, "assign_matrix rows")
    ci_sel = _sel_or_all(col_indices, C.ncols, "assign_matrix cols")
    if (A.nrows, A.ncols) != (ri_sel.size, ci_sel.size):
        raise dim.DimensionException(
            f"assign_matrix: A {A.shape} != selection "
            f"({ri_sel.size}, {ci_sel.size})")
    ar, ac, av = A.extract_tuples()
    if mask is not None:
        if (mask.nrows, mask.ncols) != (A.nrows, A.ncols):
            raise dim.DimensionException(
                f"assign_matrix: mask {mask.shape} != A {A.shape}")
        keep = _in_sorted(_mask_keys(mask), ar * A.ncols + ac)
        ar, ac, av = ar[keep], ac[keep], av[keep]
    return _assign_entries(C, ri_sel[ar], ci_sel[ac], av, accum)


def assign_matrix_scalar(C: Matrix, value, row_indices=None,
                         col_indices=None, mask: Optional[Matrix] = None,
                         accum=None, desc: Descriptor = DEFAULT) -> Matrix:
    """C[row_indices, col_indices] ⊕?= mask .* value (reference:
    operations.hpp:535-552). The len(ri) × len(ci) block is built whole:
    keep selections preprocessing-sized."""
    ri_sel = _sel_or_all(row_indices, C.nrows, "assign_matrix_scalar rows")
    ci_sel = _sel_or_all(col_indices, C.ncols, "assign_matrix_scalar cols")
    tr = np.repeat(np.arange(ri_sel.size, dtype=np.int64), ci_sel.size)
    tc = np.tile(np.arange(ci_sel.size, dtype=np.int64), ri_sel.size)
    if mask is not None:
        if (mask.nrows, mask.ncols) != (ri_sel.size, ci_sel.size):
            raise dim.DimensionException(
                f"assign_matrix_scalar: mask {mask.shape} != selection")
        keep = _in_sorted(_mask_keys(mask), tr * ci_sel.size + tc)
        tr, tc = tr[keep], tc[keep]
    tv = np.full(tr.size, value, _numpy_dtype(C.dtype))
    return _assign_entries(C, ri_sel[tr], ci_sel[tc], tv, accum)


def _vector_entries(u: Vector, n_sel: int, mask, desc, what: str):
    """(keep, values) of the dense u over a selection of n_sel lanes, keep
    the lanes the mask passes (all without a mask)."""
    uv = u.to_dense(0).dense.cpu().numpy()
    if uv.shape[0] != n_sel:
        raise dim.DimensionException(
            f"{what}: u size {uv.shape[0]} != {n_sel}")
    keep = np.ones(n_sel, bool)
    if mask is not None:
        if mask.n != n_sel:
            raise dim.DimensionException(f"{what}: mask size")
        keep = _mask_dense(mask).cpu().numpy() != 0
        if desc.mask_scmp:
            keep = ~keep
    return keep, uv[keep]


def assign_matrix_col(C: Matrix, u: Vector, row_indices, col_index: int,
                      mask: Optional[Vector] = None, accum=None,
                      desc: Descriptor = DEFAULT) -> Matrix:
    """C[row_indices, col_index] ⊕?= mask .* u (reference:
    operations.hpp:462-480): every lane of the dense u is assigned, or the
    lanes the mask passes."""
    if not 0 <= col_index < C.ncols:
        raise dim.DimensionException(
            f"assign_matrix_col: col {col_index} out of range")
    ri_sel = _sel_or_all(row_indices, C.nrows, "assign_matrix_col rows")
    keep, tv = _vector_entries(u, ri_sel.size, mask, desc,
                               "assign_matrix_col")
    tr = ri_sel[keep]
    return _assign_entries(C, tr, np.full(tr.size, col_index, np.int64), tv,
                           accum)


def assign_matrix_row(C: Matrix, u: Vector, row_index: int, col_indices,
                      mask: Optional[Vector] = None, accum=None,
                      desc: Descriptor = DEFAULT) -> Matrix:
    """C[row_index, col_indices] ⊕?= mask .* u (reference:
    operations.hpp:482-500)."""
    if not 0 <= row_index < C.nrows:
        raise dim.DimensionException(
            f"assign_matrix_row: row {row_index} out of range")
    ci_sel = _sel_or_all(col_indices, C.ncols, "assign_matrix_row cols")
    keep, tv = _vector_entries(u, ci_sel.size, mask, desc,
                               "assign_matrix_row")
    tc = ci_sel[keep]
    return _assign_entries(C, np.full(tc.size, row_index, np.int64), tc, tv,
                           accum)


def eWiseAdd_matrix(A: Matrix, B: Matrix, op,
                    mask: Optional[Matrix] = None,
                    desc: Descriptor = DEFAULT) -> Matrix:
    """C = mask .* (A ⊕ B) over the union of the structures (reference:
    operations.hpp:300-318). `op` is a BinaryOp, Monoid or Semiring (its
    ⊕); an entry in one operand passes through. One dedup pass folds
    duplicate slots within an operand and A ∩ B with the same ⊕, A's entry
    first. The result has the operands' promoted dtype and A's format."""
    dim.check_row_row(A, B, "eWiseAdd_matrix")
    if A.ncols != B.ncols:
        raise dim.DimensionException(
            f"eWiseAdd_matrix: A {A.shape} vs B {B.shape}")
    binop = _binop_of(op, use_mul=False)
    ar, ac, av = A.extract_tuples()
    br, bc, bv = B.extract_tuples()
    keys = np.concatenate([ar * A.ncols + ac, br * A.ncols + bc])
    out_dt = torch.promote_types(A.dtype, B.dtype)
    np_dt = _numpy_dtype(out_dt)
    vals = np.concatenate([av.astype(np_dt), bv.astype(np_dt)])
    uk, out_v = _dedupe_coo(keys, vals, combine=binop)
    out_r, out_c = uk // A.ncols, uk % A.ncols
    if mask is not None:
        if (mask.nrows, mask.ncols) != (A.nrows, A.ncols):
            raise dim.DimensionException("eWiseAdd_matrix: mask shape")
        keep = _in_sorted(_mask_keys(mask), uk)
        out_r, out_c, out_v = out_r[keep], out_c[keep], out_v[keep]
    return Matrix.from_coo(out_r, out_c, out_v, A.nrows, A.ncols,
                           dtype=out_dt, fmt=A.format, device=A.device)


# ---------------------------------------------------------------------------
# matrix scaling (reference: eWiseMult matrix∘scalar, ewisemult.hpp:275-344,
# and matrix∘broadcast vector, eWiseMultRowInner/ColInner, :470-620; the PR
# driver's A = α·A/outdegree prep, example/gpr.cu:82-98)
# ---------------------------------------------------------------------------


def _scale_vals(A: Matrix, fn, breaks_symmetry: bool) -> Matrix:
    """fn(val, row_ids, col_ids) → new values, applied to the padded CSR and
    CSC value arrays, each with its own index arrays (csc_row_ind carries
    the row id of each CSC-ordered entry) even where they alias the CSR's
    through structural symmetry: index-dependent scaling breaks value
    symmetry, so the result keeps its own CSC values."""
    new_val = fn(A.val, A.row_ind, A.col_ind) if A.val is not None else None
    new_csc = (fn(A.csc_val, A.csc_row_ind, A.csc_col_ind)
               if A.csc_val is not None else None)
    return Matrix(A.nrows, A.ncols, A.nvals, A.row_ptr, A.col_ind, A.row_ind,
                  new_val, A.col_ptr, A.csc_row_ind, A.csc_col_ind, new_csc,
                  format=A.format,
                  symmetric=A.symmetric and not breaks_symmetry)


def eWiseMult_matrix_scalar(A: Matrix, op, value) -> Matrix:
    """A' = A ⊗ c elementwise over stored values."""
    binop = _binop_of(op, use_mul=True)
    return _scale_vals(
        A, lambda v, r, c: binop(v, torch.tensor(value, dtype=v.dtype)),
        breaks_symmetry=False)


def scale_matrix(A: Matrix, op, value, desc: Descriptor = DEFAULT) -> Matrix:
    """B = op(A, value) over the stored values (reference: scale,
    operations.hpp:711-726)."""
    return eWiseMult_matrix_scalar(A, op, value)


def scale_vector(u: Vector, op, value, desc: Descriptor = DEFAULT) -> Vector:
    """w = op(u, value) over the stored values (reference: scale,
    operations.hpp:728-741): a sparse u's stored slots (its pads too, which
    no reader takes), every lane of a dense u."""
    binop = _binop_of(op, use_mul=True)
    if u.storage == Storage.SPARSE:
        return Vector(u.n, Storage.SPARSE, sind=u.sind,
                      sval=binop(u.sval, ew.scalar_like(value, u.sval)),
                      snvals=u.snvals)
    return Vector(u.n, Storage.DENSE,
                  dense=binop(u.dense, ew.scalar_like(value, u.dense)))


def scale_matrix_rows(A: Matrix, vec: Vector, op) -> Matrix:
    """A'[i,j] = op(A[i,j], vec[i]) (reference: eWiseMultRowInner). Padding
    entries carry the row sentinel nrows in row_ind and read vec[n-1]."""
    dim.check_row_size(A, vec, "scaleRows", "vec")
    binop = _binop_of(op, use_mul=True)
    vd = vec.to_dense(0).dense

    def fn(v, r, c):
        return binop(v, vd[r.clamp(max=vec.n - 1).long()]).to(v.dtype)

    return _scale_vals(A, fn, breaks_symmetry=True)


def scale_matrix_cols(A: Matrix, vec: Vector, op) -> Matrix:
    """A'[i,j] = op(A[i,j], vec[j]) (reference: eWiseMultColInner). The
    CSC's padding carries the column sentinel ncols in csc_col_ind and
    reads vec[n-1], as JAX's clamp has it."""
    dim.check_col_size(A, vec, "scaleCols", "vec")
    binop = _binop_of(op, use_mul=True)
    vd = vec.to_dense(0).dense

    def fn(v, r, c):
        return binop(v, vd[c.clamp(max=vec.n - 1).long()]).to(v.dtype)

    return _scale_vals(A, fn, breaks_symmetry=True)


# ---------------------------------------------------------------------------
# transpose / tril / trace (reference: operations.hpp:682-886)
# ---------------------------------------------------------------------------


def transpose(A: Matrix) -> Matrix:
    """Aᵀ (reference: transpose.hpp:39-114 cusparseScsr2csc). With dual
    CSR+CSC storage this swaps the two orientations and copies nothing: the
    CSC becomes the CSR, and a one-sided format becomes the other. The
    result has its own plan cache."""
    fmt = {SparseFormat.CSRONLY: SparseFormat.CSCONLY,
           SparseFormat.CSCONLY: SparseFormat.CSRONLY}.get(A.format, A.format)
    return Matrix(A.ncols, A.nrows, A.nvals,
                  row_ptr=A.col_ptr, col_ind=A.csc_row_ind,
                  row_ind=A.csc_col_ind, val=A.csc_val,
                  col_ptr=A.row_ptr, csc_row_ind=A.col_ind,
                  csc_col_ind=A.row_ind, csc_val=A.val,
                  format=fmt, symmetric=A.symmetric,
                  _host_csr=A._host_csc, _host_csc=A._host_csr)


def tril(A: Matrix) -> Matrix:
    """The strictly lower triangle (reference: tri.hpp:10-53, a host CSR
    walk; TC's preprocessing): a host filter c < r, built on A's device."""
    r, c, v = A.extract_tuples()
    keep = c < r
    return Matrix.from_coo(r[keep], c[keep], v[keep], A.nrows, A.ncols,
                           dtype=A.dtype, device=A.device)


def trace_mxm_transpose(A: Matrix, B: Matrix,
                        semiring: Semiring) -> torch.Tensor:
    """Tr(A ⊕.⊗ Bᵀ) = ⊕_i ⊕_k A[i,k] ⊗ B[i,k] over the ids rows i of A and
    B share (reference: operations.hpp:700-711 → trace.hpp:13-49), a 0-d
    tensor of A's dtype."""
    return spgemm.intersect_rows_reduce(A, B, semiring)
