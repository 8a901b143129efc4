"""Push-direction SpMSpV: sparse frontier × the push orientation, any
semiring (counterpart of graphblast_tpu/ops/spmspv.py; reference:
backend/cuda/spmspv_inner.hpp:62-320 spmspvApspieMerge).

A push iteration, in four steps:
  expansion   degree gather, exclusive cumsum, each lane's frontier slot
              (the slot starts before it, counted by a cumsum), then the
              pointer, frontier, offset and adjacency gathers (and the
              value gathers when ⊗ reads values);
  sort        the expanded edges by destination (a stable sort; Min/Max
              also by value within a destination);
  fill        each segment's ⊕-total spread over its lanes: the head's
              (Min) or tail's (Max) value, or a segmented scan's tail;
  compaction  the surviving segment heads, cumsum-compacted into the new
              frontier's sparse image, and scattered into its dense image.
Every gather goes through `take`, so on the card each launches the gather
kernel K6; the sorts, scans and scatters are torch ops, as they are jnp in
the JAX package.

Where the port departs from the JAX lowering:
  - sorts are stable, so results on the card repeat bit for bit. Min, Max
    and LogicalOr then equal the JAX package's exactly (-0.0 and +0.0 tie,
    NaN sorts last, as in `lax.sort`); Plus sums differ from JAX's by their
    order within a segment. The two-key sort of Min/Max is a stable value
    sort followed by a stable key sort; its value key maps -0.0 to +0.0 and
    every NaN to one positive NaN, so the card's radix sort ties and orders
    them as the CPU's comparison sort does;
  - JAX's `mode="drop"` scatters write one spare slot past the end (a
    buffer of n + 1 or cap + 1, sliced after), since torch index ops check
    or fault on an out-of-range id;
  - the structure-only bitmap push has one lowering, a scatter of ones:
    `GRB_PUSH_BITMAP_SORT` picks between two TPU lowerings and is not
    ported. `mxv_dual` sends a structure-only LogicalOr or Max push to the
    hand kernel P instead (`ops/kernels/bitmap_push.py`), which marks a
    bitmap and needs neither a workspace nor a sort, and a valued Min or
    Max push to `spmspv_push_exact` here, a SIMPLE push of one lane an
    edge, over slices of the frontier (`dispatch._push_sliced`);
    `spmspv_push` and `spmspv_push_sparse` serve every other push and the
    operations API;
  - `spmspv_push_sparse` always builds both images whole: the JAX
    package's `build_dense`, `out_cap` and `stale_dense`, which serve its
    opt-in one-image frontier protocol, are not ported.

⊗ is applied as mul(matrix_entry, frontier_entry) for mxv and vxm alike;
swap_mul=True flips it. The frontier is padded (ind, val, nvals) tensors;
the expanded edge workspace has `edge_cap` lanes, which the caller sizes to
the frontier's degree total (`dispatch.route_lanes`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..semiring import Semiring
from ..types import INDEX_DTYPE
from .gather_dispatch import take
from .segops import segmented_scan
from .spmv import mask_pass

# ⊕ under which a structure-only push marks each destination once: the
# duplicates' 1s need no reduce (the bitmap pushes)
DUP_INSENSITIVE = ("LogicalOrMonoid", "MaximumMonoid")
# ⊕ whose MERGE reduce is the two-key sort's head (Min) or tail (Max)
_ORDERED = ("MinimumMonoid", "MaximumMonoid")
# ⊕ of the SIMPLE scatter-combine push (load_balance SIMPLE)
_SCATTER = {"PlusMonoid": None, "MinimumMonoid": "amin",
            "MaximumMonoid": "amax", "LogicalOrMonoid": "amax"}


def _run_ranks(starts: torch.Tensor) -> torch.Tensor:
    """Each lane's run: the count of run starts at or before it, minus one
    (-1 before the first). It takes the place of JAX's forward fills by
    cummax, since torch.cummax of one long row runs in one block on the
    card (21 ms over 7.6 M lanes); a cumsum scans the row in one pass."""
    return torch.cumsum(starts, 0, dtype=INDEX_DTYPE) - 1


def _new_segment(keys: torch.Tensor, at_head: bool) -> torch.Tensor:
    """Bool: True where a lane starts (heads) or ends (tails) its run of
    equal keys; lane 0 is always a head and the last lane a tail."""
    edge = keys[1:] != keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    return torch.cat([one, edge] if at_head else [edge, one])


def frontier_degrees(ptr: torch.Tensor, f_ind: torch.Tensor,
                     f_nvals) -> torch.Tensor:
    """Row lengths of the frontier's vertices, int32 (reference:
    indirectScanKernel, spmspv_inner.hpp:111-119); pad slots (slot >=
    f_nvals) report 0. Two ascending gathers of ptr."""
    n = ptr.shape[0] - 1
    fi = f_ind.clamp(max=n - 1)   # compacted frontier ids ascend
    slot = torch.arange(f_ind.shape[0], dtype=INDEX_DTYPE,
                        device=f_ind.device)
    deg = take(ptr, fi + 1, sorted=True) - take(ptr, fi, sorted=True)
    return torch.where(slot < f_nvals, deg, 0)


def expand_lanes(ptr: torch.Tensor, n_edges: int, f_ind: torch.Tensor,
                 f_nvals, edge_cap: int):
    """(src_slot, edge_idx, total): each of the edge_cap lanes' frontier
    slot and edge id (clamped into the n_edges edge arrays), and the true
    expanded edge count (a 0-d tensor). Lanes past edge_cap are cut, as
    JAX's are.

    Lane e's slot is the last nonempty slot that starts at or before e
    (IntervalExpand / IntervalGatherIndirect, spmspv_inner.hpp:178-207),
    found without a binary search: the lanes count the slot starts before
    them (`_run_ranks`; a start past the workspace is dropped) and look
    the rank up among the nonempty slots. JAX scatters each slot's id at
    its start and forward-fills it by cummax; the slots equal its. Six
    gathers: two of the degrees, then the slot by rank, and the frontier
    ids, the offsets and the row starts at each lane's slot."""
    n = ptr.shape[0] - 1
    fcap = f_ind.shape[0]
    dev = f_ind.device
    deg = frontier_degrees(ptr, f_ind, f_nvals)
    offsets = torch.cumsum(deg, 0, dtype=INDEX_DTYPE) - deg   # exclusive
    total = offsets[-1] + deg[-1]
    nonempty = deg > 0
    # the nonempty slots' ids by rank (0 where there is none, as JAX's
    # fill of an empty workspace gives)
    slot_of_rank = torch.zeros(fcap + 1, dtype=INDEX_DTYPE, device=dev)
    slot_of_rank[torch.where(nonempty, _run_ranks(nonempty), fcap).long()] = (
        torch.arange(fcap, dtype=INDEX_DTYPE, device=dev))
    # index_fill_ takes the 1 as an argument; an index_put_ of a Python
    # number would copy it from the host and wait for the stream
    starts = torch.zeros(edge_cap + 1, dtype=INDEX_DTYPE, device=dev)
    starts.index_fill_(0, torch.where(nonempty & (offsets < edge_cap),
                                      offsets, edge_cap).long(), 1)
    src_slot = take(slot_of_rank, _run_ranks(starts[:edge_cap]).clamp(min=0),
                    sorted=True)

    fi = take(f_ind, src_slot, sorted=True).clamp(max=n - 1)
    within = (torch.arange(edge_cap, dtype=INDEX_DTYPE, device=dev)
              - take(offsets, src_slot, sorted=True))
    edge_idx = (take(ptr, fi, sorted=True) + within).clamp(0, n_edges - 1)
    return src_slot, edge_idx, total


def expand_frontier(ptr: torch.Tensor, ind: torch.Tensor,
                    mat_val: Optional[torch.Tensor], f_ind: torch.Tensor,
                    f_val: Optional[torch.Tensor], f_nvals, edge_cap: int,
                    structure_only: bool, semiring: Semiring, out_dtype,
                    swap_mul: bool = False):
    """The frontier's adjacency as flat lanes: (dst, mv, valid, total), the
    destination ids, the ⊗ products, the lanes that hold an edge, and the
    true expanded edge count (`expand_lanes`), then the adjacency gather
    and, where ⊗ reads values, the two value gathers."""
    dev = f_ind.device
    src_slot, edge_idx, total = expand_lanes(ptr, ind.shape[0], f_ind,
                                             f_nvals, edge_cap)
    dst = take(ind, edge_idx, sorted=True)
    valid = torch.arange(edge_cap, dtype=INDEX_DTYPE, device=dev) < total

    if structure_only:
        mv = torch.ones(edge_cap, dtype=out_dtype, device=dev)
    else:
        # eager: both operands are gathered even where ⊗ reads one (XLA
        # drops the unused gather)
        a = take(mat_val, edge_idx, sorted=True).to(out_dtype)
        b = (take(f_val, src_slot, sorted=True).to(out_dtype)
             if f_val is not None
             else torch.ones(edge_cap, dtype=out_dtype, device=dev))
        if swap_mul:
            a, b = b, a
        mv = semiring.mul(a, b).to(out_dtype)
    return dst, mv, valid, total


def spmspv_push(ptr: torch.Tensor, ind: torch.Tensor,
                mat_val: Optional[torch.Tensor], f_ind: torch.Tensor,
                f_val: Optional[torch.Tensor], f_nvals, semiring: Semiring,
                n_out: int, edge_cap: int,
                mask_dense: Optional[torch.Tensor] = None,
                mask_scmp: bool = False, structure_only: bool = False,
                sort_push: bool = True, swap_mul: bool = False,
                out_dtype=None) -> torch.Tensor:
    """Dense-output push: y = the ⊕-scatter of the frontier's edge
    products, (n_out,) with the identity where no edge lands or the mask
    fails.

    (ptr, ind, mat_val) is the push orientation: A's CSR for vxm, its CSC
    for mxv (operations.hpp:82-209). Three lowerings, as in the JAX
    package: the structure-only bitmap push for LogicalOr and Max ⊕ (a
    scatter of ones: duplicates write the same 1, so no reduce); the
    SIMPLE scatter-combine for Plus, Min, Max and LogicalOr when
    `sort_push` is False (kernels/spmspv.hpp:92-184; index_add_ sums in
    atomics' order on the card); else the MERGE sort push."""
    if out_dtype is None:
        out_dtype = f_val.dtype if f_val is not None else torch.float32
    ident = semiring.identity(out_dtype).item()
    dst, mv, valid, _ = expand_frontier(
        ptr, ind, mat_val, f_ind, f_val, f_nvals, edge_cap, structure_only,
        semiring, out_dtype, swap_mul)
    tgt = torch.where(valid, dst, n_out)
    add_name = semiring.add.name
    y = torch.full((n_out + 1,), ident, dtype=out_dtype, device=dst.device)
    if structure_only and add_name in DUP_INSENSITIVE:
        # both identities are 0, so max(identity, 1) is the 1 written
        y.index_fill_(0, tgt.long(), 1)
    elif not sort_push and add_name in _SCATTER:
        if add_name == "PlusMonoid":
            y.index_add_(0, tgt.long(), torch.where(valid, mv, 0))
        else:
            src = ((mv != 0).to(out_dtype) if add_name == "LogicalOrMonoid"
                   else mv)
            y.scatter_reduce_(0, tgt.long(), src, _SCATTER[add_name])
    else:
        keys, seg_val, _ = _merge_reduce(tgt, mv, semiring, edge_cap, False)
        # every lane writes its segment's total: the duplicates agree
        y[keys.long()] = seg_val
    y = y[:n_out]
    if mask_dense is not None:
        y = torch.where(mask_pass(mask_dense, mask_scmp), y, ident)
    return y


def spmspv_push_exact(ptr: torch.Tensor, ind: torch.Tensor,
                      mat_val: torch.Tensor, f_ind: torch.Tensor,
                      f_val: Optional[torch.Tensor], edges: int,
                      semiring: Semiring, n_out: int,
                      mask_dense: Optional[torch.Tensor] = None,
                      mask_scmp: bool = False,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SIMPLE scatter push of a valued Min or Max ⊕ (`_SCATTER`) over
    a frontier without pads, f_ind ascending, whose degree total `edges`
    the host knows: one lane an edge, so no lane is cut or idle and no
    workspace rounding, lane validity or clamp is needed. Each lane finds
    its frontier slot by a repeat of the slot ids (`output_size` given, so
    the stream does not wait), its edge from its row's start; six gathers
    through `take` (two of the row pointers, the lanes' edge bases, the
    adjacency, the edge and frontier values). ⊗ is mul(matrix_entry,
    frontier_entry); the result equals `spmspv_push`'s for the same ⊕,
    which ignores the order of its operands. `out`, a dense result of an
    earlier push, takes this push's lanes too (⊕ into it, in place).
    Fewer, larger ops than the workspace push, so a small frontier's push
    keeps the card busier."""
    out_dtype = f_val.dtype if f_val is not None else torch.float32
    ident = semiring.identity(out_dtype).item()
    dev = f_ind.device
    y = (torch.full((n_out,), ident, dtype=out_dtype, device=dev)
         if out is None else out)
    if edges:
        row0 = take(ptr, f_ind, sorted=True)
        deg = take(ptr, f_ind + 1, sorted=True) - row0
        slots = torch.arange(f_ind.shape[0], dtype=INDEX_DTYPE, device=dev)
        slot = torch.repeat_interleave(slots, deg, output_size=edges)
        # each slot's first edge id less its first lane: + the lane is the
        # lane's edge
        base = row0 - (torch.cumsum(deg, 0, dtype=INDEX_DTYPE) - deg)
        edge = take(base, slot, sorted=True) + torch.arange(
            edges, dtype=INDEX_DTYPE, device=dev)
        a = take(mat_val, edge, sorted=True).to(out_dtype)
        b = (take(f_val, slot, sorted=True).to(out_dtype)
             if f_val is not None else torch.ones_like(a))
        y.scatter_reduce_(0, take(ind, edge, sorted=True).long(),
                          semiring.mul(a, b).to(out_dtype),
                          _SCATTER[semiring.add.name])
    if mask_dense is not None:
        y = torch.where(mask_pass(mask_dense, mask_scmp), y, ident)
    return y


def sort_segments(tgt: torch.Tensor, mv: torch.Tensor, semiring: Semiring,
                  dup_insensitive: bool):
    """The MERGE push's sort: (keys, vals, heads), the lanes ordered by
    destination, stably. Duplicate-insensitive ⊕ sorts the keys alone and
    returns vals None; Min/Max sort by value within a key, so a segment's
    head holds its min and its tail its max."""
    if dup_insensitive:
        keys = torch.sort(tgt, stable=True).values
        return keys, None, _new_segment(keys, True)
    if semiring.add.name in _ORDERED:
        skey = mv
        if mv.is_floating_point():
            # -0.0 + 0.0 is +0.0: the zeros tie, in lane order
            skey = torch.where(mv.isnan(), float("nan"), mv + 0.0)
        by_val = torch.sort(skey, stable=True).indices
        by_key = torch.sort(tgt[by_val], stable=True).indices
        perm = by_val[by_key]
    else:
        perm = torch.sort(tgt, stable=True).indices
    keys = tgt[perm]
    return keys, mv[perm], _new_segment(keys, True)


def fill_segments(keys: torch.Tensor, vals: Optional[torch.Tensor],
                  heads: torch.Tensor, semiring: Semiring,
                  dtype) -> torch.Tensor:
    """Each segment's ⊕-total on every lane of the segment: 1 when
    `sort_segments` returned no vals (duplicate-insensitive ⊕), the head's
    value for Min, the tail's for Max, else a segmented scan's tail.

    The total is written once a segment, at the segment's number
    (`_run_ranks` of the heads), and gathered back at every lane's number:
    the same values as JAX's fill of the head's or tail's position by
    cummax, with one gather, as JAX has."""
    cap = keys.shape[0]
    if vals is None:
        return torch.ones(cap, dtype=dtype, device=keys.device)
    if semiring.add.name == "MinimumMonoid":
        ends = heads
    else:
        if semiring.add.name != "MaximumMonoid":
            vals = segmented_scan(vals, heads, semiring.add)
        ends = _new_segment(keys, False)   # the tails
    seg = _run_ranks(heads)
    totals = vals.new_empty(cap + 1)   # slots past the last segment unread
    totals[torch.where(ends, seg, cap).long()] = vals
    return take(totals, seg, sorted=True)


def _merge_reduce(tgt: torch.Tensor, mv: torch.Tensor, semiring: Semiring,
                  edge_cap: int, dup_insensitive: bool):
    """Sort the expanded edges by destination and ⊕-reduce each segment
    (MERGE mode, spmspv_inner.hpp:219-317). Returns (keys, seg_val, heads):
    the sorted keys, each segment's ⊕-total on every lane of it, and the
    segment heads. edge_cap is the lanes' count, tgt.shape[0]."""
    keys, vals, heads = sort_segments(tgt, mv, semiring, dup_insensitive)
    return keys, fill_segments(keys, vals, heads, semiring, mv.dtype), heads


def compact_heads(keys: torch.Tensor, seg_val: torch.Tensor,
                  keep: torch.Tensor, n_out: int, ident,
                  with_values: bool = True):
    """The kept segment heads compacted to the front of the images: (y,
    sind, sval or None, nv), y and sind (n_out,) and sval (n_out,) with
    values. sind pads with n_out, sval and y with the identity; dropped
    lanes write a spare slot. One write per kept segment."""
    dev = keys.device
    nv = keep.sum().to(INDEX_DTYPE)
    pos = torch.cumsum(keep, 0, dtype=INDEX_DTYPE) - 1
    spos = torch.where(keep, pos, n_out).long()
    sind = torch.full((n_out + 1,), n_out, dtype=INDEX_DTYPE, device=dev)
    sind[spos] = keys.to(INDEX_DTYPE)
    sval = None
    if with_values:
        sval = torch.full((n_out + 1,), ident, dtype=seg_val.dtype,
                          device=dev)
        sval[spos] = seg_val
        sval = sval[:n_out]
    y = torch.full((n_out + 1,), ident, dtype=seg_val.dtype, device=dev)
    y[torch.where(keep, keys, n_out).long()] = seg_val
    return y[:n_out], sind[:n_out], sval, nv


def spmspv_push_sparse(ptr: torch.Tensor, ind: torch.Tensor,
                       mat_val: Optional[torch.Tensor], f_ind: torch.Tensor,
                       f_val: Optional[torch.Tensor], f_nvals,
                       semiring: Semiring, n_out: int, edge_cap: int,
                       mask_dense: Optional[torch.Tensor] = None,
                       mask_scmp: bool = False, structure_only: bool = False,
                       swap_mul: bool = False, out_dtype=None,
                       with_values: bool = True, postprocess_sparse=None):
    """MERGE push with both output images: (y_dense, sind, sval, nv).

    The destination sort already orders the expanded edges, so the new
    frontier is the segment heads that survive, compacted inside the
    workspace: no full-n sort (spmspv_inner.hpp:300-317). A segment whose
    ⊕-total is the identity is dropped: the dense image holds the identity
    there and the sparse image no entry. sind is (n_out,), valid entries
    ascending at the front, pad n_out: the sparse_from_dense layout.

    `postprocess_sparse(keys, vals) -> vals` filters each segment's total
    before the keep decision and must map the identity to itself (SSSP's
    unproductive filter, sssp.hpp:76-88)."""
    if out_dtype is None:
        out_dtype = f_val.dtype if f_val is not None else torch.float32
    ident = semiring.identity(out_dtype).item()
    dst, mv, valid, _ = expand_frontier(
        ptr, ind, mat_val, f_ind, f_val, f_nvals, edge_cap, structure_only,
        semiring, out_dtype, swap_mul)
    tgt = torch.where(valid, dst, n_out)
    dup_ok = structure_only and semiring.add.name in DUP_INSENSITIVE
    keys, seg_val, heads = _merge_reduce(tgt, mv, semiring, edge_cap, dup_ok)
    key_ids = keys.clamp(max=n_out - 1)
    if postprocess_sparse is not None:
        seg_val = postprocess_sparse(key_ids, seg_val)
    keep = heads & (keys < n_out) & (seg_val != ident)
    if mask_dense is not None:
        keep &= mask_pass(take(mask_dense, key_ids, sorted=True), mask_scmp)
    return compact_heads(keys, seg_val, keep, n_out, ident, with_values)
