"""Elementwise, assign, reduce, gather and scatter ops on tensors
(counterpart of graphblast_tpu/ops/elementwise.py; reference:
backend/cuda/{ewisemult,ewiseadd,assign,scatter,gather,reduce}.hpp).

The semantics are the JAX package's:
  - eWiseMult applies the semiring's ⊗, eWiseAdd its ⊕ (the operations
    layer extracts the op);
  - a mask passes where it is nonzero, and scmp complements it; an entry
    that fails keeps the OLD output value for assign
    (kernels/assign_dense.hpp:23-28) and gets the identity for the compute
    ops (ewisemult.hpp:109-169);
  - sparse + dense eWiseAdd copies the dense operand and ⊕-scatters the
    sparse entries into it (ewiseadd.hpp:93-160);
  - sparse assign sets the stored entries where the mask passes and then
    prunes the entries equal to the assigned value (assign.hpp:107-245),
    SSSP's frontier filter.
JAX's `mode="drop"` scatters write one spare slot past the end, sliced
off after, since torch index ops check or fault on an out-of-range id.
"""
from __future__ import annotations

import torch

from ..semiring import BinaryOp, Monoid
from ..types import INDEX_DTYPE
from .segops import reduce_all, segment_reduce_csr
from .spmv import mask_pass


def scalar_like(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (a number, or a 0-d tensor on the host such as a monoid's
    identity) as a 0-d tensor of like's dtype on its device, made there by
    a fill: a copy from the host would wait for the stream."""
    if isinstance(value, torch.Tensor):
        value = value.item()
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _apply_mask_identity(out, mask_dense, scmp, ident):
    if mask_dense is None:
        return out
    return torch.where(mask_pass(mask_dense, scmp), out, ident)


# ---------------------------------------------------------------------------
# eWiseMult / eWiseAdd
# ---------------------------------------------------------------------------


def ewise_binary_dense(u: torch.Tensor, v, op: BinaryOp, ident,
                       mask_dense=None, mask_scmp: bool = False
                       ) -> torch.Tensor:
    """w = op(u, v) elementwise, of u's dtype; masked-out entries get
    `ident`. v may be a scalar (the vector∘constant variants,
    ewisemult.hpp:275-344, ewiseadd.hpp:161-283)."""
    vt = v.to(u.dtype) if isinstance(v, torch.Tensor) else scalar_like(v, u)
    out = op(u, vt).to(u.dtype)
    return _apply_mask_identity(out, mask_dense, mask_scmp,
                                scalar_like(ident, u))


def ewise_add_sparse_dense(n: int, sind: torch.Tensor, sval: torch.Tensor,
                           snvals, v_dense: torch.Tensor,
                           op: BinaryOp) -> torch.Tensor:
    """w = v (a copy), then w[ind] = op(sval, w[ind]) at the stored
    entries (ewiseadd.hpp:93-160)."""
    slot = torch.arange(sind.shape[0], dtype=INDEX_DTYPE, device=sind.device)
    tgt = torch.where(slot < snvals, sind, n)
    merged = op(sval.to(v_dense.dtype),
                v_dense[tgt.clamp(max=n - 1).long()]).to(v_dense.dtype)
    out = torch.cat([v_dense, v_dense.new_zeros(1)])
    out[tgt.long()] = merged
    return out[:n]


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def apply_unary_dense(u: torch.Tensor, fn, mask_dense=None,
                      mask_scmp: bool = False,
                      keep_old: bool = True) -> torch.Tensor:
    """w = fn(u); where the mask fails, u's old value (or 0 without
    keep_old)."""
    out = fn(u)
    if mask_dense is None:
        return out
    keep = u if keep_old else torch.zeros_like(out)
    return torch.where(mask_pass(mask_dense, mask_scmp), out, keep)


# ---------------------------------------------------------------------------
# assign (masked constant), reference: assign.hpp:14-245
# ---------------------------------------------------------------------------


def assign_constant_dense(w: torch.Tensor, value, mask_dense=None,
                          mask_scmp: bool = False) -> torch.Tensor:
    """w[i] = value where the mask passes; the rest keep w[i]
    (assignDenseDenseMaskedKernel, kernels/assign_dense.hpp:10-40)."""
    val = scalar_like(value, w)
    if mask_dense is None:
        return val.expand_as(w).clone()
    return torch.where(mask_pass(mask_dense, mask_scmp), val, w)


def assign_constant_sparse(n: int, sind: torch.Tensor, sval: torch.Tensor,
                           snvals, value, mask_dense,
                           mask_scmp: bool = False):
    """Masked constant assign on a sparse image, then the entries equal to
    the value pruned (assignSparse, assign.hpp:107-245: assignSparseKernel,
    updateFlagKernel, stream compaction). Returns the new (sind, sval,
    snvals), of the same capacity."""
    cap = sind.shape[0]
    val = scalar_like(value, sval)
    slot_valid = (torch.arange(cap, dtype=INDEX_DTYPE, device=sind.device)
                  < snvals)
    if mask_dense is not None:
        hit = mask_pass(mask_dense[sind.clamp(max=n - 1).long()],
                        mask_scmp) & slot_valid
        new_val = torch.where(hit, val, sval)
    else:
        new_val = torch.where(slot_valid, val, sval)
    keep = slot_valid & (new_val != val)
    pos = torch.cumsum(keep, 0, dtype=INDEX_DTYPE) - 1
    tgt = torch.where(keep, pos, cap).long()
    out_ind = torch.full((cap + 1,), n, dtype=INDEX_DTYPE,
                         device=sind.device)
    out_ind[tgt] = sind
    out_val = sval.new_zeros(cap + 1)
    out_val[tgt] = new_val
    return out_ind[:cap], out_val[:cap], keep.sum().to(INDEX_DTYPE)


# ---------------------------------------------------------------------------
# scatter / gather (reference: scatter.hpp, gather.hpp, CC's primitives)
# ---------------------------------------------------------------------------


def _drop_out_of_range(n: int, indices: torch.Tensor) -> torch.Tensor:
    """int64 ids as JAX's `.at[indices].set(..., mode="drop")` reads them:
    an id in [-n, 0) counts from the end, as NumPy's does, and every id
    still outside [0, n) goes to the spare slot n, which is dropped."""
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def scatter_indexed(w: torch.Tensor, u: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """w[indices[i]] = u[i] (scatterIndexedKernel, scatter.hpp:85-123,
    assignScatter's engine). Where indices repeat, one write wins, as in
    the reference and in XLA's scatter; which one is not specified."""
    n = w.shape[0]
    out = torch.cat([w, w.new_zeros(1)])
    out[_drop_out_of_range(n, indices)] = u.to(w.dtype)
    return out[:n]


def gather_indexed(u: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """w[i] = u[clamp(indices[i])] (gatherIndexedKernel, gather.hpp:11-49,
    extractGather's engine)."""
    return u[indices.long().clamp(0, u.shape[0] - 1)]


def scatter_constant(w: torch.Tensor, value,
                     indices: torch.Tensor) -> torch.Tensor:
    """w[indices[i]] = value (scatterKernel, scatter.hpp:11-80)."""
    n = w.shape[0]
    out = torch.cat([w, w.new_zeros(1)])
    out.index_fill_(0, _drop_out_of_range(n, indices),
                    scalar_like(value, w))
    return out[:n]


# ---------------------------------------------------------------------------
# reduce (reference: reduce.hpp)
# ---------------------------------------------------------------------------


def reduce_dense_vector(u: torch.Tensor, monoid: Monoid) -> torch.Tensor:
    """vector → scalar, a 0-d tensor (reduce.hpp:13-50, CUB
    DeviceReduce)."""
    return reduce_all(u, monoid)


def reduce_sparse_vector(sval: torch.Tensor, snvals, monoid: Monoid,
                         structure_only: bool = False) -> torch.Tensor:
    """Sparse vector → scalar over its stored slots, the identity in the
    pad slots; structure_only gives the count (reduce.hpp:71-75)."""
    if structure_only:
        return torch.as_tensor(snvals).to(sval.dtype)
    slot_valid = (torch.arange(sval.shape[0], dtype=INDEX_DTYPE,
                               device=sval.device) < snvals)
    return reduce_all(torch.where(slot_valid, sval, monoid.identity(
        sval.dtype).item()), monoid)


def reduce_matrix_rows(row_ptr: torch.Tensor, val: torch.Tensor,
                       monoid: Monoid, nrows: int) -> torch.Tensor:
    """matrix → vector row reduce (reduce.hpp:109-145, CUB
    DeviceSegmentedReduce over the row pointers), the degree and
    weight-sum primitive: segops.segment_reduce_csr over the padded
    values, for every monoid."""
    return segment_reduce_csr(val, row_ptr, monoid, nrows)
