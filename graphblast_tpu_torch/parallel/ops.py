"""Distributed matvec primitives over a 1D mesh (counterpart of
graphblast_tpu/parallel/ops.py).

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
  sparse push (`dist_vxm_push_sparse`): the same expansion, one stable sort
        groups the (destination, value) pairs by owner (`owner_buckets`),
        and an all-to-all of P fixed blocks of `pair_cap` pairs carries
        them, so the exchange scales with the frontier, not with n; the
        owner ⊕-combines what it receives with the push's sort and fill.
        Where a bucket overflows pair_cap on any rank, every rank takes
        the dense push instead;
  scalars: all-reduce.

Every function takes this rank's arrays and the mesh's process group, and
every rank of the group must call it. The JAX collectives map as
all_gather(tiled) → all-gather into one tensor, psum / pmin / pmax →
all_reduce SUM / MIN / MAX, psum_scatter → reduce-scatter, all_to_all →
all_to_all_single. A branch that only some ranks would take deadlocks
in its collectives, so every branch is taken on an all-reduced value read
on the host (JAX's lax.cond on a pmax).
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..ops.kernels.bitmap_pull import pack_bitmap, spmv_bitmap_pull
from ..ops.kernels.value_pull import spmv_value_pull
from ..ops.segops import reduce_all
from ..ops.gather_dispatch import take
from ..ops.spmspv import (expand_frontier, fill_segments, sort_segments,
                          spmspv_push)
from ..ops.spmv import mask_pass, spmv_pull
from ..semiring import Semiring
from ..types import INDEX_DTYPE
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


def owner_buckets(csr_ptr, csr_ind, csr_val, f_ind_local, f_val_local,
                  f_nvals_local, semiring: Semiring, P: int, rows_per: int,
                  edge_cap: int, structure_only: bool, out_dtype):
    """Expand this rank's frontier block and group the (destination, ⊗
    product) pairs by owner rank: (owner_sorted, dst_local_sorted,
    val_sorted, (bounds, counts)). bounds are the P+1 group starts in the
    sorted lanes and counts[k] the LIVE pairs bound for rank k, the
    quantity accounting.sparse_push_live_pairs predicts. Lanes past the
    expansion have owner P and sort last. The sort by owner is stable, so
    each group keeps the expansion's lane order."""
    dev = f_ind_local.device
    if csr_ind.shape[0] == 0:
        # a block with no edges expands nothing: every lane is dead
        dst = torch.zeros(edge_cap, dtype=INDEX_DTYPE, device=dev)
        mv = torch.full((edge_cap,), semiring.identity(out_dtype).item(),
                        dtype=out_dtype, device=dev)
        valid = torch.zeros(edge_cap, dtype=torch.bool, device=dev)
    else:
        dst, mv, valid, _ = expand_frontier(
            csr_ptr, csr_ind, csr_val, f_ind_local, f_val_local,
            f_nvals_local, edge_cap, structure_only, semiring, out_dtype)
    owner = torch.where(valid, dst // rows_per, P).to(INDEX_DTYPE)
    dst_local = (dst - owner * rows_per).to(INDEX_DTYPE)
    perm = torch.sort(owner, stable=True).indices
    ow_s, dl_s, mv_s = owner[perm], dst_local[perm], mv[perm]
    bounds = torch.searchsorted(ow_s, torch.arange(
        P + 1, dtype=INDEX_DTYPE, device=dev)).to(INDEX_DTYPE)
    counts = bounds[1:] - bounds[:-1]
    return ow_s, dl_s, mv_s, (bounds, counts)


def _any_over(pred: torch.Tensor, group=None) -> bool:
    """Whether pred holds anywhere on any rank: an all-reduce MAX read on
    the host, so every rank gets the same answer."""
    flag = pred.any().to(INDEX_DTYPE).reshape(1)
    return bool(all_reduce(flag, dist.ReduceOp.MAX, group).item())


def dist_vxm_push_sparse(csr_ptr, csr_ind, csr_val, f_ind_local, f_val_local,
                         f_nvals_local, semiring: Semiring, P: int,
                         rows_per: int, edge_cap: int, pair_cap: int,
                         mask_block=None, mask_scmp=False,
                         structure_only=False, group=None) -> torch.Tensor:
    """Push w = u ⊗ A from this rank's frontier block with the sparse,
    owner-bucketed exchange (arguments as `dist_vxm_push`):

      1. expand the frontier through the row block (K6 on the card) and
         sort the pairs by owner (`owner_buckets`);
      2. cut P windows of pair_cap lanes at the group starts, each lane
         past its group's count dead (destination rows_per, value the
         identity). The sorted lanes are padded by pair_cap with that
         sentinel first, so a window that starts near the end never
         reaches another owner's pairs;
      3. one all-to-all of the ids and one of the values, P·pair_cap each;
      4. sort the received pairs by destination and spread each segment's
         ⊕-total (the push's sort_segments / fill_segments), then write
         one total a destination.

    When a bucket of any rank holds more than pair_cap pairs, every rank
    takes the dense push (`dist_vxm_push`); the predicate is all-reduced
    and read on the host, one read a call. Min, Max and LogicalOr equal
    the JAX package's exactly; Plus sums may differ in their order."""
    out_dtype = (f_val_local.dtype if f_val_local is not None
                 else torch.float32)
    ident = semiring.identity(out_dtype).item()
    _, dl_s, mv_s, (bounds, counts) = owner_buckets(
        csr_ptr, csr_ind, csr_val, f_ind_local, f_val_local, f_nvals_local,
        semiring, P, rows_per, edge_cap, structure_only, out_dtype)
    if _any_over(counts > pair_cap, group):
        w_block = dist_vxm_push(csr_ptr, csr_ind, csr_val, f_ind_local,
                                f_val_local, f_nvals_local, semiring, P,
                                rows_per, edge_cap,
                                structure_only=structure_only, group=group)
    else:
        dev = dl_s.device
        dl_s = torch.cat([dl_s, torch.full((pair_cap,), rows_per,
                                           dtype=dl_s.dtype, device=dev)])
        mv_s = torch.cat([mv_s, torch.full((pair_cap,), ident,
                                           dtype=mv_s.dtype, device=dev)])
        lane = torch.arange(pair_cap, dtype=INDEX_DTYPE, device=dev)
        # the windows ascend, so their lanes are one ascending gather
        win = (bounds[:P, None] + lane[None, :]).reshape(-1)
        live = (lane[None, :] < counts[:, None]).reshape(-1)
        idx_out = torch.where(live, take(dl_s, win, sorted=True), rows_per)
        val_out = torch.where(live, take(mv_s, win, sorted=True), ident)
        idx_in = torch.empty_like(idx_out)
        val_in = torch.empty_like(val_out)
        dist.all_to_all_single(idx_in, idx_out.contiguous(), group=group)
        dist.all_to_all_single(val_in, val_out.contiguous(), group=group)
        tgt = torch.where(idx_in < rows_per, idx_in, rows_per)
        dup_ok = structure_only and semiring.add.name in ("LogicalOrMonoid",
                                                          "MaximumMonoid")
        keys, vals, heads = sort_segments(tgt, val_in, semiring, dup_ok)
        seg = fill_segments(keys, vals, heads, semiring, out_dtype)
        w = torch.full((rows_per + 1,), ident, dtype=out_dtype, device=dev)
        # every lane writes its segment's total: the duplicates agree
        w[keys.long()] = seg.to(out_dtype)
        w_block = w[:rows_per]
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
