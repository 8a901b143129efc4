"""Vector container: dense or padded-sparse (counterpart of
graphblast_tpu/vector.py; reference: graphblas/vector.hpp:12-221).

A sparse image has a fixed capacity and an `snvals` count; pad slots carry
the index sentinel n. Methods return new Vectors.

The constructors take NumPy arrays, lists or tensors. A tensor stays on its
device unless `device` names another; anything else goes to "cuda" unless
`device` says otherwise. `sparse_from(..., nvals=k)` takes a padded sparse
image as the JAX package keeps it (its sind, sval and snvals), so a JAX
Vector carries across unchanged through `np.asarray` of its fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .types import INDEX_DTYPE, Storage


def to_tensor(values, dtype=None, device=None) -> torch.Tensor:
    """`values` as a tensor of `dtype` (its own if None) on `device`: a
    tensor's own device when it is None, else "cuda" unless named."""
    if isinstance(values, torch.Tensor):
        dev = values.device if device is None else resolve_device(device)
        return values.to(device=dev, dtype=dtype or values.dtype)
    arr = np.asarray(values)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


@dataclasses.dataclass(frozen=True)
class Vector:
    """Dense or padded-sparse vector of logical size n."""

    n: int
    storage: Storage
    dense: Optional[torch.Tensor] = None
    sind: Optional[torch.Tensor] = None
    sval: Optional[torch.Tensor] = None
    snvals: Optional[torch.Tensor] = None   # int32 scalar tensor

    # -- constructors -------------------------------------------------------
    @staticmethod
    def dense_from(values, device=None) -> "Vector":
        values = to_tensor(values, device=device)
        return Vector(int(values.shape[0]), Storage.DENSE, dense=values)

    @staticmethod
    def full(n: int, value, dtype: torch.dtype = torch.float32,
             device=None) -> "Vector":
        """fill() (reference: vector.hpp:131-141); always dense."""
        return Vector(n, Storage.DENSE, dense=torch.full(
            (n,), value, dtype=dtype, device=resolve_device(device)))

    @staticmethod
    def ascending(n: int, dtype: torch.dtype = INDEX_DTYPE,
                  device=None) -> "Vector":
        """fillAscending (reference: vector.hpp:143-151): v[i] = i."""
        return Vector(n, Storage.DENSE, dense=torch.arange(
            n, dtype=dtype, device=resolve_device(device)))

    @staticmethod
    def sparse_from(n: int, indices, values,
                    dtype: torch.dtype = torch.float32,
                    cap: Optional[int] = None, device=None,
                    nvals: Optional[int] = None) -> "Vector":
        """build() sparse (reference: vector.hpp:88-106): the stored
        entries at the front of `cap` slots (default n), pads with index n
        and value 0. With `nvals`, `indices` and `values` are already the
        padded slots (a JAX Vector's sind and sval) and the first `nvals`
        of them are stored; cap defaults to their length."""
        ind = np.asarray(indices, dtype=np.int64)
        val = np.asarray(values)
        if nvals is None:
            nv = len(ind)
            cap = n if cap is None else cap
        else:
            nv = int(nvals)
            cap = len(ind) if cap is None else cap
            ind, val = ind[:nv], val[:nv]
        sind = np.full(cap, n, dtype=np.int32)
        sind[:nv] = ind
        sval = torch.zeros(cap, dtype=dtype)
        sval[:nv] = torch.from_numpy(np.array(val, copy=True)).to(dtype)
        dev = resolve_device(device)
        return Vector(n, Storage.SPARSE, sind=torch.from_numpy(sind).to(dev),
                      sval=sval.to(dev),
                      snvals=torch.tensor(nv, dtype=INDEX_DTYPE, device=dev))

    # -- properties ---------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return (self.dense if self.dense is not None else self.sval).dtype

    @property
    def device(self) -> torch.device:
        return (self.dense if self.dense is not None else self.sval).device

    @property
    def cap(self) -> int:
        return int(self.sind.shape[0]) if self.sind is not None else self.n

    def nvals(self, identity=0) -> torch.Tensor:
        """Stored-entry count, an int32 0-d tensor: snvals when sparse, the
        non-identity entries when dense (computeNnz,
        dense_vector.hpp:42)."""
        if self.storage == Storage.SPARSE:
            return self.snvals
        return (self.dense != identity).sum().to(INDEX_DTYPE)

    def check(self, expect_sorted: bool = False) -> bool:
        """The storage invariants, on the host (the Vector analog of
        Matrix.check): dense has length n; sparse has snvals within the
        capacity, stored indices in bounds (ascending with
        `expect_sorted`, which a compaction gives and set_element does
        not) and the sentinel n in every pad slot. Raises ValueError."""
        if self.storage == Storage.DENSE:
            if tuple(self.dense.shape) != (self.n,):
                raise ValueError("dense length")
            return True
        nv = int(self.snvals)
        if not 0 <= nv <= self.cap:
            raise ValueError("snvals within capacity")
        si = self.sind.cpu().numpy()
        live = si[:nv]
        if live.min(initial=0) < 0 or (nv and live.max() >= self.n):
            raise ValueError("sparse indices in bounds")
        if expect_sorted and np.any(np.diff(live) < 0):
            raise ValueError("sparse indices ascending")
        if np.any(si[nv:] < self.n):
            raise ValueError("pad sentinel")
        return True

    # -- element ops --------------------------------------------------------
    def set_element(self, value, index: int) -> "Vector":
        """setElement (reference: vector.hpp:153-167): dense writes the
        slot; sparse appends (index, value) after the stored entries, and a
        write past the capacity is dropped, as JAX's scatter drops it,
        while snvals still counts it."""
        if self.storage == Storage.DENSE:
            dense = self.dense.clone()
            dense[index] = value
            return dataclasses.replace(self, dense=dense)
        nv = int(self.snvals)
        sind, sval = self.sind.clone(), self.sval.clone()
        if nv < self.cap:
            sind[nv] = index
            sval[nv] = value
        return dataclasses.replace(self, sind=sind, sval=sval,
                                   snvals=self.snvals + 1)

    def to_sparse(self, identity=0) -> "Vector":
        """dense2sparse (reference: vector.hpp:367-425)."""
        if self.storage == Storage.SPARSE:
            return self
        sind, sval, nv = sparse_from_dense(self.dense, identity)
        return Vector(self.n, Storage.SPARSE, sind=sind, sval=sval,
                      snvals=nv)

    def extract_tuples(self):
        """(indices, values) of the stored entries, NumPy arrays on the
        host (reference: vector.hpp:169-186); dense stores every slot."""
        if self.storage == Storage.DENSE:
            return np.arange(self.n), self.dense.cpu().numpy()
        nv = int(self.snvals)
        return (self.sind[:nv].cpu().numpy(), self.sval[:nv].cpu().numpy())

    def count_unique(self) -> int:
        """countUnique (reference: vector.hpp:204-215)."""
        return len(np.unique(self.to_numpy()))

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
