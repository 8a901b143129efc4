"""GraphBLAS operations (counterpart of graphblast_tpu/operations.py;
reference: graphblas/operations.hpp).

Ported so far: the three operations PageRank's matrix prep composes
(`prepare_pr_matrix`, reference example/gpr.cu:82-90): the row reduce
`reduce_matrix_to_vector`, `eWiseMult_matrix_scalar` and
`scale_matrix_rows`; and triangle counting's: `tril`, the masked `mxm` and
`trace_mxm_transpose` (ops/spgemm.py); and `transpose`, which the CLI's
--transpose takes. The rest of the surface is ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import dimension as dim
from .descriptor import DEFAULT, Descriptor
from .matrix import Matrix
from .ops import spgemm
from .semiring import BinaryOp, Monoid, Semiring, extract_add, extract_mul
from .types import SparseFormat, Storage
from .vector import Vector

# monoid name -> scatter_reduce reduction; the logical monoids reduce the
# 0/1 truth of each value
_ROW_REDUCE = {"PlusMonoid": "sum", "MultipliesMonoid": "prod",
               "MinimumMonoid": "amin", "MaximumMonoid": "amax",
               "LogicalOrMonoid": "amax", "LogicalAndMonoid": "amin"}


def _binop_of(op, use_mul: bool) -> BinaryOp:
    if isinstance(op, Semiring):
        return extract_mul(op) if use_mul else extract_add(op).op
    if isinstance(op, Monoid):
        return op.op
    return op


def reduce_matrix_to_vector(A: Matrix, monoid: Monoid,
                            desc: Descriptor = DEFAULT) -> Vector:
    """matrix → vector row reduce (reference: operations.hpp:620-641): the
    monoid over each row's stored values, its identity on empty rows."""
    how = _ROW_REDUCE.get(monoid.name)
    if how is None:
        raise NotImplementedError(
            f"row reduce over {monoid.name} is not ported (only the "
            f"associative monoids {sorted(_ROW_REDUCE)}): ROADMAP queue 1 "
            "item 7")
    if A.row_ptr is None:
        raise ValueError("reduce_matrix_to_vector needs A's CSR")
    vals = A.val[: A.nvals]
    rows = A.row_ind[: A.nvals].long()
    if monoid.name.startswith("Logical"):
        vals = (vals != 0).to(vals.dtype)
    out = torch.full((A.nrows,), monoid.identity(vals.dtype).item(),
                     dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, rows, vals, how, include_self=False)
    return Vector(A.nrows, Storage.DENSE, dense=out)


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


def scale_matrix_rows(A: Matrix, vec: Vector, op) -> Matrix:
    """A'[i,j] = op(A[i,j], vec[i]) (reference: eWiseMultRowInner). Padding
    entries carry the row sentinel nrows in row_ind and read vec[n-1]."""
    dim.check_row_size(A, vec, "scaleRows", "vec")
    binop = _binop_of(op, use_mul=True)
    vd = vec.to_dense(0).dense

    def fn(v, r, c):
        return binop(v, vd[r.clamp(max=vec.n - 1).long()]).to(v.dtype)

    return _scale_vals(A, fn, breaks_symmetry=True)


def mxm(A: Matrix, B: Matrix, semiring: Semiring,
        mask: Optional[Matrix] = None, desc: Descriptor = DEFAULT) -> Matrix:
    """C = A ⊕.⊗ B on the structure of `mask` (reference: spgemm.hpp:85-87,
    C inherits the mask's sparsity); desc.transpose_inp1 takes Bᵀ (TC's
    idiom, tc.hpp:24). Unmasked SpGEMM is not ported."""
    b_inner = B.ncols if desc.transpose_inp1 else B.nrows
    if A.ncols != b_inner:
        raise dim.DimensionException(
            f"mxm: dimension mismatch — A is {A.shape}, "
            f"B{'ᵀ' if desc.transpose_inp1 else ''} inner dim {b_inner}")
    if mask is None:
        raise NotImplementedError("unmasked mxm (spgemm_esc) is not ported: "
                                  "ROADMAP queue 1 item 7")
    dim.check_row_row(A, mask, "mxm")
    return spgemm.spgemm_masked(A, B, mask, semiring,
                                transpose_b=desc.transpose_inp1)


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
