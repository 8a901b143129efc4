"""DenseMatrix: a dense (nrows, ncols) operand (counterpart of
graphblast_tpu/dense_matrix.py; reference: backend/cuda/dense_matrix.hpp:
17-80, and gemm.hpp / gemv.hpp, which the reference declares and never
implements).

One tensor at the logical shape. The methods that change a matrix return
a new one, as Vector's and Matrix's do. `operations.mxm_dense` takes a
DenseMatrix as its B; `gemm` and `gemv` are the dense × dense and
dense × vector products.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import dimension as dim
from .config import resolve_device
from .ops.segops import reduce_dim
from .semiring import BinaryOp, Semiring
from .vector import to_tensor


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense matrix: `data` (nrows, ncols). nvals is nrows·ncols by
    definition (reference: dense_matrix.hpp:23): a dense container stores
    every entry."""

    nrows: int
    ncols: int
    data: torch.Tensor

    # --- constructors (reference: nnew / build overloads) -----------------
    @staticmethod
    def zeros(nrows: int, ncols: int, dtype: torch.dtype = torch.float32,
              device=None) -> "DenseMatrix":
        return DenseMatrix(nrows, ncols, torch.zeros(
            nrows, ncols, dtype=dtype, device=resolve_device(device)))

    @staticmethod
    def from_dense(arr, device=None) -> "DenseMatrix":
        """A 2-D array or tensor (a tensor stays on its device unless
        `device` names another; anything else goes to "cuda" unless
        `device` says otherwise)."""
        a = to_tensor(arr, device=device)
        if a.dim() != 2:
            raise ValueError(f"DenseMatrix.from_dense: need 2D, got "
                             f"{tuple(a.shape)}")
        return DenseMatrix(int(a.shape[0]), int(a.shape[1]), a)

    @staticmethod
    def build(values, nrows: int, ncols: int, device=None) -> "DenseMatrix":
        """Row-major flat build (reference: build(values, nvals),
        dense_matrix.hpp:40-41)."""
        return DenseMatrix(nrows, ncols, to_tensor(values, device=device)
                           .reshape(nrows, ncols))

    @staticmethod
    def from_coo(rows, cols, vals, nrows: int, ncols: int,
                 dup: Optional[BinaryOp] = None,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> "DenseMatrix":
        """COO build with duplicates combined by `dup` (reference: the
        templated build(row_indices, col_indices, values, nvals, dup));
        slots with no entry are 0. dup=None keeps the LAST duplicate, "plus"
        sums them, any other op folds them in order, on the host, as the
        JAX package does."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = torch.as_tensor(np.asarray(vals)).to(dtype)
        host = torch.zeros(nrows, ncols, dtype=dtype)
        if dup is None:
            host[rows, cols] = vals
        elif dup.name == "plus":
            host.index_put_((torch.from_numpy(rows), torch.from_numpy(cols)),
                            vals, accumulate=True)
        else:
            acc = {}
            for r, c, v in zip(rows, cols, vals):
                key = (int(r), int(c))
                acc[key] = dup(acc[key], v) if key in acc else v
            for (r, c), v in acc.items():
                host[r, c] = v
        return DenseMatrix(nrows, ncols, host.to(resolve_device(device)))

    # --- the C API's surface (dense_matrix.hpp:29-61) ---------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def nvals(self) -> int:
        return self.nrows * self.ncols

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def dup(self) -> "DenseMatrix":
        return DenseMatrix(self.nrows, self.ncols, self.data.clone())

    def clear(self) -> "DenseMatrix":
        return DenseMatrix(self.nrows, self.ncols,
                           torch.zeros_like(self.data))

    def set_element(self, val, i: int, j: int) -> "DenseMatrix":
        data = self.data.clone()
        data[i, j] = val
        return DenseMatrix(self.nrows, self.ncols, data)

    def extract_element(self, i: int, j: int) -> torch.Tensor:
        return self.data[i, j]

    def extract_tuples(self):
        """(row ids, col ids, values) of every slot, row-major, NumPy on
        the host (reference: extractTuples, dense_matrix.hpp:45-49)."""
        r = np.repeat(np.arange(self.nrows, dtype=np.int64), self.ncols)
        c = np.tile(np.arange(self.ncols, dtype=np.int64), self.nrows)
        return r, c, self.data.cpu().numpy().reshape(-1)

    def fill(self, value) -> "DenseMatrix":
        return DenseMatrix(self.nrows, self.ncols,
                           torch.full_like(self.data, value))

    def fill_ascending(self, start=0) -> "DenseMatrix":
        """Row-major ascending fill (reference: fillAscending,
        dense_matrix.hpp:60-61)."""
        a = (torch.arange(self.nvals, device=self.device).to(self.dtype)
             + torch.as_tensor(start, dtype=self.dtype).to(self.device))
        return DenseMatrix(self.nrows, self.ncols,
                           a.reshape(self.nrows, self.ncols))

    def resize(self, nrows: int, ncols: int) -> "DenseMatrix":
        """Grow or shrink, keeping the overlapping block (reference:
        resize)."""
        out = torch.zeros(nrows, ncols, dtype=self.dtype, device=self.device)
        r, c = min(nrows, self.nrows), min(ncols, self.ncols)
        out[:r, :c] = self.data[:r, :c]
        return DenseMatrix(nrows, ncols, out)

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix(self.ncols, self.nrows, self.data.T)

    @property
    def T(self) -> "DenseMatrix":
        return self.transpose()

    def to_dense(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def check(self) -> None:
        """The container's invariant: data at the logical shape."""
        if tuple(self.data.shape) != (self.nrows, self.ncols):
            raise ValueError(
                f"DenseMatrix.check: data {tuple(self.data.shape)} != "
                f"logical ({self.nrows}, {self.ncols})")


# ---------------------------------------------------------------------------
# dense products (reference: gemm.hpp / gemv.hpp, declared, unimplemented)
# ---------------------------------------------------------------------------


def _plus_times(semiring: Semiring) -> bool:
    return (semiring.add.name == "PlusMonoid"
            and semiring.mul.name == "multiplies")


def gemm(A: DenseMatrix, B: DenseMatrix, semiring: Semiring,
         out_dtype: torch.dtype = None) -> DenseMatrix:
    """C = A ⊕.⊗ B, dense × dense, of the operands' promoted dtype.
    Plus-times is one torch.matmul (a plain product outside any kernel, as
    JAX's jnp.matmul is); any other semiring folds over k in order, one
    (M, N) pass a step: C ← C ⊕ (A[:, k] ⊗ B[k, :]) from ⊕'s identity, as
    JAX's lax.scan does."""
    if A.ncols != B.nrows:
        raise dim.DimensionException(
            f"gemm: inner dim mismatch — A {A.shape} × B {B.shape}")
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)
    Ad, Bd = A.data.to(out_dtype), B.data.to(out_dtype)
    if _plus_times(semiring):
        return DenseMatrix(A.nrows, B.ncols, torch.matmul(Ad, Bd))
    C = torch.full((A.nrows, B.ncols), semiring.identity(out_dtype).item(),
                   dtype=out_dtype, device=Ad.device)
    for k in range(A.ncols):
        C = semiring.add(C, semiring.mul(Ad[:, k, None], Bd[None, k, :]))
    return DenseMatrix(A.nrows, B.ncols, C.to(out_dtype))


def gemv(A: DenseMatrix, x, semiring: Semiring,
         out_dtype: torch.dtype = None) -> torch.Tensor:
    """y = A ⊕.⊗ x, dense matrix × dense vector: torch.matmul for
    plus-times, else ⊗ broadcast over A's rows and the ⊕ reduce of each
    row (`segops.reduce_dim`, as JAX's lax.reduce)."""
    x = to_tensor(x, device=A.device)
    if A.ncols != x.shape[0]:
        raise dim.DimensionException(
            f"gemv: dim mismatch — A {A.shape} × x {tuple(x.shape)}")
    out_dtype = out_dtype or torch.promote_types(A.dtype, x.dtype)
    Ad, xd = A.data.to(out_dtype), x.to(out_dtype)
    if _plus_times(semiring):
        return torch.matmul(Ad, xd)
    return reduce_dim(semiring.mul(Ad, xd[None, :]), semiring.add, 1)
