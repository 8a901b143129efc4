"""Vector container: dense or padded-sparse (counterpart of
graphblast_tpu/vector.py; reference: graphblas/vector.hpp:12-221).

A sparse image has a fixed capacity and an `snvals` count; pad slots carry
the index sentinel n. Methods return new Vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .types import INDEX_DTYPE, Storage


@dataclasses.dataclass(frozen=True)
class Vector:
    """Dense or padded-sparse vector of logical size n."""

    n: int
    storage: Storage
    dense: Optional[torch.Tensor] = None
    sind: Optional[torch.Tensor] = None
    sval: Optional[torch.Tensor] = None
    snvals: Optional[torch.Tensor] = None   # int32 scalar tensor

    @property
    def dtype(self) -> torch.dtype:
        return (self.dense if self.dense is not None else self.sval).dtype

    def to_dense(self, identity=0) -> "Vector":
        """sparse2dense (reference: vector.hpp:326-364)."""
        if self.storage == Storage.DENSE:
            return self
        return Vector(self.n, Storage.DENSE,
                      dense=dense_from_sparse(self.n, self.sind, self.sval,
                                              self.snvals, identity))

    def to_numpy(self, identity=0) -> np.ndarray:
        return self.to_dense(identity).dense.cpu().numpy()

    def __repr__(self):
        return (f"Vector(n={self.n}, storage={self.storage.name}, "
                f"dtype={self.dtype})")


def dense_from_sparse(n: int, sind: torch.Tensor, sval: torch.Tensor,
                      snvals: torch.Tensor, identity) -> torch.Tensor:
    """Scatter stored entries over an identity-filled dense array. Pad slots
    (slot >= snvals) are dropped, as the reference's bounds-checked scatter
    does (vector.hpp:326-364)."""
    cap = sind.shape[0]
    slot = torch.arange(cap, dtype=INDEX_DTYPE, device=sind.device)
    live = (slot < snvals) & (sind >= 0) & (sind < n)
    out = torch.full((n,), identity, dtype=sval.dtype, device=sval.device)
    out[sind[live].long()] = sval[live]
    return out


def sparse_from_dense(dense: torch.Tensor, identity,
                      with_values: bool = True):
    """Stream-compact non-identity entries by a sort (reference:
    vector.hpp:367-425 flag → scan → compact): valid indices ascend to the
    front, pad slots carry the sentinel n. Capacity n, so nothing
    overflows. Returns (sind, sval or None, nvals)."""
    n = dense.shape[0]
    flags = dense != identity
    arange = torch.arange(n, dtype=INDEX_DTYPE, device=dense.device)
    sind = torch.sort(torch.where(flags, arange, n)).values
    sval = None
    if with_values:
        # the identity goes in as a scalar argument: a tensor made from it
        # on the card would be copied from the host, waiting for the stream
        sval = torch.where(sind < n, dense[sind.clamp(max=n - 1).long()],
                           identity).to(dense.dtype)
    nv = flags.sum().to(INDEX_DTYPE)
    return sind, sval, nv
