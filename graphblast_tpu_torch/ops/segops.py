"""Segmented scan and reduce over CSR edge arrays (counterpart of
graphblast_tpu/ops/segops.py; the reference's moderngpu SpmvCsrBinary /
ReduceByKey and CUB DeviceSegmentedReduce layer).

A row's reduction is written as: edge values → segmented inclusive scan →
gather at the segment tails, with prefix-sum differences for Plus and
LogicalOr. The gathers go through `take`, so on the card they launch the
gather kernel K6; the scan itself is torch ops, as it is jnp in the JAX
package. All arrays are padded to a static length; no segment reaches the
padding past row_ptr[nrows].

On the plan-less pull (`spmv.spmv_pull`) the min/max semirings on int32
and float32 frontiers no longer come here: they take the row-fold kernel S
(`kernels/minmax_pull.py`). The pull still reduces here with Plus and
LogicalOr (the cumsum differences) and with Multiplies, LogicalAnd,
Greater, CustomLess and NotEqualTo (the Hillis–Steele scan), and with
min/max on other dtypes.

`segment_reduce_sorted` reduces by sorted segment ids, as the push's
reduce-by-key does, and `reduce_all` reduces a whole array (the operations
surface). `segment_reduce_csr`'s `edge_row_ids`, which only the sorted pull
(`spmv_pull_sorted`) passes, is not ported.
"""
from __future__ import annotations

import torch

from ..semiring import Monoid
from .gather_dispatch import take


def segment_heads(row_ptr: torch.Tensor, nnz_pad: int) -> torch.Tensor:
    """Bool (nnz_pad,): True at the first edge of every row segment, edge 0
    always. Pointers past nnz_pad are dropped, as JAX's mode="drop"."""
    flags = torch.zeros(nnz_pad + 2, dtype=torch.bool, device=row_ptr.device)
    flags[row_ptr.long().clamp(0, nnz_pad + 1)] = True
    flags[0] = True
    return flags[:nnz_pad]


def segmented_scan(values: torch.Tensor, heads: torch.Tensor,
                   monoid: Monoid) -> torch.Tensor:
    """Inclusive segmented scan down dim 0 with any monoid, unrolled
    Hillis–Steele (⌈log₂ n⌉ steps): at step k, v[i] = v[i-k] ⊕ v[i]
    unless a segment head lies in (i-k, i], and f[i] |= f[i-k]. Shifted-in
    slots carry the identity and a head flag, as in the JAX package. The
    identity goes in as a scalar argument: a tensor of it copied to the
    card would wait for the stream, a host read a call."""
    n = values.shape[0]
    ident = monoid.identity(values.dtype).item()
    v, f = values, heads
    k = 1
    while k < n:
        vk = torch.cat([v.new_full((k,) + v.shape[1:], ident), v[:-k]])
        fk = torch.cat([torch.ones((k,) + f.shape[1:], dtype=torch.bool,
                                   device=f.device), f[:-k]])
        v = torch.where(f, v, monoid(vk, v))
        f = f | fk
        k *= 2
    return v


def row_boundary_csum(csum: torch.Tensor,
                      row_ptr: torch.Tensor) -> torch.Tensor:
    """csum[row_ptr - 1], 0 where row_ptr is 0: one gather of the sorted row
    boundaries, since a row's start is the previous row's end. A float64
    csum gathers as its two 4-byte words a boundary, in the same one
    launch of the 4-byte gather."""
    idx = (row_ptr - 1).clamp(min=0)
    if csum.dtype == torch.float64:
        words = (2 * idx.long()[:, None] + torch.arange(
            2, device=idx.device)).reshape(-1)
        bnd = take(csum.view(torch.int32), words, sorted=True).view(
            torch.float64)
    else:
        bnd = take(csum, idx, sorted=True)
    return torch.where(row_ptr > 0, bnd, torch.zeros((), dtype=csum.dtype,
                                                     device=csum.device))


def segment_reduce_csr(edge_vals: torch.Tensor, row_ptr: torch.Tensor,
                       monoid: Monoid, nrows: int) -> torch.Tensor:
    """Per-row ⊕ of edge values laid out in CSR order, (nrows,); empty rows
    give the identity. Plus (not on bool) and LogicalOr difference prefix
    sums at the row boundaries; every other monoid runs the flag scan and
    fetches the segment tails.

    torch.cumsum of int32 gives int64: dtype= keeps it int32, so the
    boundary gather stays on the kernel and the sums wrap as JAX's int32
    cumsum does. A float32 sum differences float64 prefix sums: a float32
    prefix over all the edges holds a row's sum only to a few ulps of the
    running total (0.06 at RMAT scale 18 on the card, where a row sums to
    about 200), where JAX's float32 cumsum loses it too."""
    if row_ptr.shape[0] != nrows + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, want "
                         f"{nrows + 1}")
    nnz_pad = edge_vals.shape[0]
    if monoid.name == "PlusMonoid" and edge_vals.dtype != torch.bool:
        acc = (torch.float64 if edge_vals.dtype == torch.float32
               else edge_vals.dtype)
        bnd = row_boundary_csum(torch.cumsum(edge_vals, 0, dtype=acc),
                                row_ptr)
        return (bnd[1:] - bnd[:-1]).to(edge_vals.dtype)
    if monoid.name == "LogicalOrMonoid":
        # or-reduce == the segment's nonzero count is positive
        flags = (edge_vals != 0).to(torch.int32)
        bnd = row_boundary_csum(torch.cumsum(flags, 0, dtype=torch.int32),
                                row_ptr)
        out = (bnd[1:] - bnd[:-1]) > 0
        return out if edge_vals.dtype == torch.bool else out.to(
            edge_vals.dtype)
    scanned = segmented_scan(edge_vals, segment_heads(row_ptr, nnz_pad),
                             monoid)
    starts, ends = row_ptr[:-1], row_ptr[1:]
    # a row's tail is row_ptr[i+1] - 1; empty rows give the identity
    out = take(scanned, (ends - 1).clamp(0, max(nnz_pad - 1, 0)),
               sorted=True)
    return torch.where(ends > starts, out, monoid.identity(out.dtype).item())


def segment_reduce_sorted(values: torch.Tensor, seg_ids: torch.Tensor,
                          monoid: Monoid, num_segments: int) -> torch.Tensor:
    """⊕ of `values` by *sorted* segment ids into (num_segments,), the
    identity where no id falls (reference analog: mgpu ReduceByKey,
    spmspv_inner.hpp:302). Ids at or past num_segments are padding and
    dropped, as JAX's mode="drop" drops them: they write a spare slot."""
    ident = monoid.identity(values.dtype).item()
    new_seg = seg_ids[1:] != seg_ids[:-1]
    one = torch.ones(1, dtype=torch.bool, device=seg_ids.device)
    scanned = segmented_scan(values, torch.cat([one, new_seg]), monoid)
    # each run's inclusive scan ends at its tail: one write per segment
    tails = torch.cat([new_seg, one])
    tgt = torch.where(tails & (seg_ids >= 0) & (seg_ids < num_segments),
                      seg_ids, num_segments)
    out = torch.full((num_segments + 1,), ident, dtype=values.dtype,
                     device=values.device)
    out[tgt.long()] = scanned
    return out[:num_segments]


# the catalog's ops whose value is 0 or 1 whatever their operands
# (semiring._logical and _cmp)
_TWO_VALUED = ("logical_or", "logical_and", "logical_xor", "equal",
               "not_equal_to", "greater", "less", "greater_equal",
               "less_equal")


def _image(code: int, a: int) -> int:
    """The image of a in {0, 1} under the map of {0, 1} into itself coded
    as image(0) + 2 * image(1)."""
    return (code >> a) & 1


# _COMPOSE[4 * f + g] is the code of g∘f (f first)
_COMPOSE = [_image(g, _image(f, 0)) + 2 * _image(g, _image(f, 1))
            for f in range(4) for g in range(4)]


def _left_fold(values: torch.Tensor, monoid: Monoid) -> torch.Tensor:
    """((identity ⊕ v[0]) ⊕ v[1]) ⊕ ... along dim 0, in index order.

    For a two-valued ⊕ (a comparison or logical op) the running value is 0
    or 1 from the first step on, so every later step is one of the four
    maps of {0, 1} into itself. Maps compose associatively: the fold is
    the composite of v[1..]'s maps, taken pairwise in ⌈log₂ k⌉ steps of
    one table lookup each, applied to the first step's value. Any other ⊕
    folds one element at a time. One element is its own reduce: the
    identity is neutral by the monoid's contract, and XLA drops it there
    too."""
    k = values.shape[0]
    if k <= 1:
        return (values[0] if k else monoid.identity(values.dtype).to(
            values.device).expand(values.shape[1:]).clone())
    acc = monoid(monoid.identity(values.dtype).to(values.device), values[0])
    rest = values[1:]
    if monoid.op.name not in _TWO_VALUED:
        for i in range(rest.shape[0]):
            acc = monoid(acc, rest[i])
        return acc
    zero, one = torch.zeros_like(acc), torch.ones_like(acc)
    maps = ((monoid(zero, rest) != 0).long()
            + 2 * (monoid(one, rest) != 0).long())
    table = torch.tensor(_COMPOSE, device=values.device)
    while maps.shape[0] > 1:
        if maps.shape[0] % 2:
            # the identity map (code 2) keeps the count even
            maps = torch.cat([maps, maps.new_full((1,) + maps.shape[1:], 2)])
        maps = table[4 * maps[0::2] + maps[1::2]]
    bit = (maps[0] >> (acc != 0).long()) & 1
    return bit.to(acc.dtype)


def reduce_dim(values: torch.Tensor, monoid: Monoid,
               dim: int) -> torch.Tensor:
    """The ⊕ reduce of `values` along `dim`, of values' dtype (reference:
    reduce.hpp:13-50, CUB DeviceReduce): sum, min, max, any or product for
    the five named monoids; any other ⊕, associative or not, is a left
    fold in index order from its identity, as the JAX package's
    `lax.reduce` folds on its CPU backend up to 32 elements (past that XLA
    reassociates, taking ⊕ to be associative). Integer sums and products
    wrap in values' dtype, as JAX's do."""
    name = monoid.name
    if name == "PlusMonoid":
        if values.dtype == torch.bool:
            return values.sum(dim).to(torch.int32)
        return values.sum(dim, dtype=values.dtype)
    if name == "MinimumMonoid":
        return values.amin(dim)
    if name == "MaximumMonoid":
        return values.amax(dim)
    if name == "LogicalOrMonoid":
        return (values != 0).any(dim).to(values.dtype)
    if name == "MultipliesMonoid":
        return values.prod(dim, dtype=values.dtype)
    return _left_fold(values.movedim(dim, 0), monoid)


def reduce_all(values: torch.Tensor, monoid: Monoid) -> torch.Tensor:
    """Full reduction of a 1-D tensor to a 0-d one (`reduce_dim` along its
    one dim)."""
    return reduce_dim(values, monoid, 0)
