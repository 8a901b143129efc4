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
reduce-by-key does. `reduce_all` (the operations surface) waits for the
slice that needs it, and so does `segment_reduce_csr`'s `edge_row_ids`,
which only the sorted pull (`spmv_pull_sorted`) passes.
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
    """Inclusive segmented scan with any monoid, unrolled Hillis–Steele
    (⌈log₂ n⌉ steps): at step k, v[i] = v[i-k] ⊕ v[i] unless a segment head
    lies in (i-k, i], and f[i] |= f[i-k]. Shifted-in slots carry the
    identity and a head flag, as in the JAX package."""
    n = values.shape[0]
    ident = monoid.identity(values.dtype).to(values.device)
    v, f = values, heads
    k = 1
    while k < n:
        vk = torch.cat([ident.expand(k), v[:-k]])
        fk = torch.cat([torch.ones(k, dtype=torch.bool, device=f.device),
                        f[:-k]])
        v = torch.where(f, v, monoid(vk, v))
        f = f | fk
        k *= 2
    return v


def row_boundary_csum(csum: torch.Tensor,
                      row_ptr: torch.Tensor) -> torch.Tensor:
    """csum[row_ptr - 1], 0 where row_ptr is 0: one gather of the sorted row
    boundaries, since a row's start is the previous row's end."""
    bnd = take(csum, (row_ptr - 1).clamp(min=0), sorted=True)
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
    cumsum does."""
    if row_ptr.shape[0] != nrows + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, want "
                         f"{nrows + 1}")
    nnz_pad = edge_vals.shape[0]
    if monoid.name == "PlusMonoid" and edge_vals.dtype != torch.bool:
        bnd = row_boundary_csum(
            torch.cumsum(edge_vals, 0, dtype=edge_vals.dtype), row_ptr)
        return bnd[1:] - bnd[:-1]
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
    return torch.where(ends > starts, out,
                       monoid.identity(out.dtype).to(out.device))


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
