"""SpMM: a sparse matrix times a dense one (counterpart of
graphblast_tpu/ops/spmm.py; the reference declares it and never implements
it, backend/cuda/spmm.hpp:16-40).

    C[i, :] = ⊕_{j ∈ A(i,:)} A[i,j] ⊗ B[j, :]

B's rows are gathered at the column ids, ⊗ applies, and each row reduces
as the JAX package reduces it: Plus by a cumsum down the edges (float64
for float32) differenced at the row boundaries, Minimum and Maximum by
the segmented scan. Any other ⊕ raises, as in the JAX package. Torch ops throughout: the gather reads
whole rows of B, which the 1-D gather kernel does not serve, as JAX's
jnp.take does not go through its `take` either.
"""
from __future__ import annotations

import torch

from ..semiring import Semiring
from .segops import segment_heads, segmented_scan


def spmm(row_ptr: torch.Tensor, col_ind: torch.Tensor,
         val, B: torch.Tensor, semiring: Semiring, nrows: int,
         row_ind: torch.Tensor = None) -> torch.Tensor:
    """C = A ⊕.⊗ B, (nrows, k) of B's dtype, with A as CSR tensors (padded:
    no row reaches past row_ptr[nrows]) and dense B (A's ncols, k).
    `row_ind`, the expanded row ids, gives the segment heads of min and
    max without a scatter. The Plus sums are differences of prefix sums
    down all the edges, as JAX's are, in float64 for float32 products
    (as `segops.segment_reduce_csr`): a float32 prefix holds a row's sum
    only to a few ulps of the running total."""
    k = B.shape[1]
    dtype = B.dtype
    eb = B[col_ind.long().clamp(0, B.shape[0] - 1)]           # (nnz, k)
    a = (val.to(dtype)[:, None] if val is not None
         else torch.ones(col_ind.shape[0], 1, dtype=dtype, device=B.device))
    prod = semiring.mul(a, eb)
    ends, starts = row_ptr[1:], row_ptr[:-1]
    add = semiring.add.name
    if add == "PlusMonoid":
        # each column's prefix sums from one 1-D scan over the columns laid
        # end to end (torch scans a (nnz, k) tensor down dim 0 one thread
        # a column: 2.9 s at RMAT scale 18 with k = 32 on the card), each
        # column's start taken off after
        acc = torch.float64 if prod.dtype == torch.float32 else prod.dtype
        csum = torch.cumsum(prod.T.contiguous().reshape(-1), 0,
                            dtype=acc).view(k, -1)
        starts = torch.cat([csum.new_zeros(1), csum[:-1, -1]])
        bnd = csum[:, (row_ptr.long() - 1).clamp(min=0)] - starts[:, None]
        bnd = torch.where((row_ptr > 0)[None, :], bnd,
                          torch.zeros((), dtype=acc, device=B.device))
        return (bnd[:, 1:] - bnd[:, :-1]).T.contiguous().to(prod.dtype)
    if add in ("MinimumMonoid", "MaximumMonoid"):
        if row_ind is not None:
            heads = torch.cat([torch.ones(1, dtype=torch.bool,
                                          device=B.device),
                               row_ind[1:] != row_ind[:-1]])
        else:
            heads = segment_heads(row_ptr, prod.shape[0])
        scanned = segmented_scan(prod, heads[:, None].expand(-1, k),
                                 semiring.add)
        tail = (ends.long() - 1).clamp(0, prod.shape[0] - 1)
        out = scanned[tail]
        return torch.where((ends > starts)[:, None], out,
                           semiring.identity(dtype).item())
    raise NotImplementedError(
        f"spmm: unsupported ⊕ monoid {semiring.add.name}")
