"""Distributed matvec primitives over a 1D mesh (counterpart of
graphblast_tpu/parallel/ops.py:34-125, 233-252).

  pull  (dense frontier): all-gather the vector's blocks into the whole
        vector, then pull over this rank's block: K1 (the bitmap pull)
        for BFS's structure-only pull, the value pull for PageRank's
        Plus-Times, spmv_pull (S for min/max, K5 + K6 or K6 otherwise)
        for the rest;
  push  (sparse frontier): expand the rank's frontier block through its
        row block (global destinations, the push's gathers on K6), then
        route the (n_pad,) partial to the blocks' owners: Plus →
        reduce-scatter; any other ⊕ → all-to-all of the P owner blocks and
        a ⊕ fold of the P partials each rank receives;
  scalars: all-reduce.

Every function takes this rank's arrays and the mesh's process group, and
every rank of the group must call it. The JAX collectives map as
all_gather(tiled) → all-gather into one tensor, psum / pmin / pmax →
all_reduce SUM / MIN / MAX, psum_scatter → reduce-scatter, all_to_all →
all_to_all_single. The owner-bucketed sparse push (`owner_buckets`,
`dist_vxm_push_sparse`) waits for ROADMAP item 10b.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..ops.kernels.bitmap_pull import pack_bitmap, spmv_bitmap_pull
from ..ops.kernels.value_pull import spmv_value_pull
from ..ops.segops import reduce_all
from ..ops.spmspv import spmspv_push
from ..ops.spmv import mask_pass, spmv_pull
from ..semiring import Semiring
from ..vector import sparse_from_dense

_REDUCE_OPS = {"PlusMonoid": dist.ReduceOp.SUM,
               "MinimumMonoid": dist.ReduceOp.MIN,
               "MaximumMonoid": dist.ReduceOp.MAX}


def all_gather(x_block: torch.Tensor, group=None) -> torch.Tensor:
    """The blocks of every rank, in rank order, as one tensor (JAX's tiled
    all_gather)."""
    P = dist.get_world_size(group)
    out = x_block.new_empty((P * x_block.shape[0],) + x_block.shape[1:])
    with warnings.catch_warnings():
        # torch 2.13 deprecates the name for all_gather_single, which older
        # releases lack; this name exists in both
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x_block.contiguous(), group=group)
    return out


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """t reduced over the ranks (in place; returned)."""
    dist.all_reduce(t, op=op, group=group)
    return t


def count(pred: torch.Tensor, group=None) -> torch.Tensor:
    """The number of True entries over all ranks' blocks, a (1,) int32
    tensor on the block's device (JAX: psum of a local sum)."""
    return all_reduce(pred.sum(dtype=torch.int32).reshape(1), group=group)


def _local_pull(ptr, ind, val, x_full, semiring: Semiring, rows_per: int,
                mask_block, mask_scmp, structure_only, sched):
    if ind.shape[0] == 0:
        # a block with no edges (a padding block): every row is empty
        ident = semiring.identity(x_full.dtype).item()
        return torch.full((rows_per,), ident, dtype=x_full.dtype,
                          device=x_full.device)
    return spmv_pull(ptr, ind, val, x_full, semiring, rows_per, mask_block,
                     mask_scmp, structure_only, sched=sched)


def dist_vxm_pull(csc_ptr, csc_ind, csc_val, x_block, semiring: Semiring,
                  rows_per: int, mask_block=None, mask_scmp=False,
                  structure_only=False, group=None, sched=None):
    """w_block = (u ⊗ A)|block: all-gather u, pull over this rank's COLUMN
    block (local columns, GLOBAL row ids, cut at its edge count: Ash.csc()).
    `sched` is the block's RowSchedule, which a min/max pull on the card
    needs (Ash.schedule(True))."""
    x_full = all_gather(x_block, group)
    return _local_pull(csc_ptr, csc_ind, csc_val, x_full, semiring, rows_per,
                       mask_block, mask_scmp, structure_only, sched)


def dist_mxv_pull(csr_ptr, csr_ind, csr_val, x_block, semiring: Semiring,
                  rows_per: int, mask_block=None, mask_scmp=False,
                  structure_only=False, group=None, sched=None):
    """w_block = (A ⊗ u)|block over this rank's ROW block (Ash.csr(), and
    Ash.schedule(False) for a min/max pull on the card)."""
    x_full = all_gather(x_block, group)
    return _local_pull(csr_ptr, csr_ind, csr_val, x_full, semiring, rows_per,
                       mask_block, mask_scmp, structure_only, sched)


def dist_value_pull(value_plan, x_block, group=None) -> torch.Tensor:
    """The Plus-Times pull over this rank's column block on the value-pull
    kernel (PageRank's local pull; JAX's dist_value_pull_dma): all-gather
    x, then one launch over the block's plan (Ash.value_pull_plan)."""
    return spmv_value_pull(value_plan, all_gather(x_block, group))


def dist_or_pull_bitmap(pull_plan, x_block, mask_block=None,
                        mask_scmp=False, group=None) -> torch.Tensor:
    """BFS's structure-only or-pull over this rank's column block on K1:
    all-gather the frontier, pack it to a bitmap, count each local row's
    frontier in-neighbours (Ash.pull_plan), threshold, mask."""
    x_full = all_gather(x_block, group)
    cnt = spmv_bitmap_pull(pull_plan, pack_bitmap(x_full))
    y = (cnt > 0).to(x_block.dtype)
    if mask_block is not None:
        y = torch.where(mask_pass(mask_block, mask_scmp), y, 0)
    return y


def _combine_partials(partial: torch.Tensor, semiring: Semiring, P: int,
                      rows_per: int, group=None) -> torch.Tensor:
    """Route a full-length (n_pad,) ⊕-partial to the block owners and
    combine: Plus → a reduce-scatter; any other monoid → an all-to-all of
    the P owner blocks, then a ⊕ fold, from the identity in rank order,
    of the P partials of this rank's block."""
    partial = partial.contiguous()
    if semiring.add.name == "PlusMonoid":
        out = partial.new_empty(rows_per)
        with warnings.catch_warnings():
            # deprecated in torch 2.13 as all_gather_into_tensor is
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, partial, op=dist.ReduceOp.SUM,
                                       group=group)
        return out
    incoming = torch.empty_like(partial)
    dist.all_to_all_single(incoming, partial, group=group)
    acc = torch.full((rows_per,), semiring.identity(partial.dtype).item(),
                     dtype=partial.dtype, device=partial.device)
    for k in range(P):
        acc = semiring.add(acc, incoming[k * rows_per:(k + 1) * rows_per])
    return acc.to(partial.dtype)


def dist_vxm_push(csr_ptr, csr_ind, csr_val, f_ind_local, f_val_local,
                  f_nvals_local, semiring: Semiring, P: int, rows_per: int,
                  edge_cap: int, mask_block=None, mask_scmp=False,
                  structure_only=False, group=None) -> torch.Tensor:
    """Push w = u ⊗ A from this rank's frontier block: f_ind_local holds
    LOCAL row ids (rows_per pads), csr_* is the row block with GLOBAL
    column ids (Ash.csr()). The port's push (ops/spmspv.py, its gathers on
    K6) scatters the products into an (n_pad,) partial, which
    `_combine_partials` routes to the owners."""
    n_pad = P * rows_per
    out_dtype = (f_val_local.dtype if f_val_local is not None
                 else torch.float32)
    ident = semiring.identity(out_dtype).item()
    if csr_ind.shape[0] == 0:
        # a block with no edges expands nothing
        partial = torch.full((n_pad,), ident, dtype=out_dtype,
                             device=csr_ptr.device)
    else:
        partial = spmspv_push(csr_ptr, csr_ind, csr_val, f_ind_local,
                              f_val_local, f_nvals_local, semiring, n_pad,
                              edge_cap, structure_only=structure_only,
                              out_dtype=out_dtype)
    w_block = _combine_partials(partial, semiring, P, rows_per, group)
    if mask_block is not None:
        w_block = torch.where(mask_pass(mask_block, mask_scmp), w_block,
                              ident)
    return w_block


def dist_reduce(x_block, monoid, group=None) -> torch.Tensor:
    """vector → scalar across the ranks: a local reduce, then an
    all-reduce for Plus, Min and Max, or an all-gather of the P locals
    and a fold in rank order for any other monoid. A 0-d tensor."""
    local = reduce_all(x_block, monoid).reshape(1).to(x_block.dtype)
    op = _REDUCE_OPS.get(monoid.name)
    if op is not None:
        return all_reduce(local, op, group)[0]
    alls = all_gather(local, group)
    acc = monoid.identity(x_block.dtype).to(x_block.device)
    for k in range(alls.shape[0]):
        acc = monoid(acc, alls[k])
    return acc.to(x_block.dtype)


def local_frontier(x_block, identity):
    """Compact this rank's dense block into (local ids, values, count)."""
    return sparse_from_dense(x_block, identity)
