"""Matrix container: dual CSR+CSC on one device (counterpart of
graphblast_tpu/matrix.py; reference: graphblas/matrix.hpp:13-251 and
backend/cuda/sparse_matrix.hpp:120-163).

The arrays keep the JAX package's layout exactly, so a graph carried across
(`from_numpy_arrays`) and a graph built here (`from_coo`) hold the same
values: edge arrays are padded to a TILE multiple, `col_ind` pads with 0,
`row_ind` (the expanded COO row ids) with the sentinel nrows. `nvals` is the
true edge count, and no kernel reads past ptr[n]. When the graph is
structurally symmetric the CSC tensors alias the CSR ones.

`_host_csr` / `_host_csc` keep NumPy copies of the unpadded CSR/CSC, as the
JAX package does; `_plans` caches kernel plans per pull orientation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import default_sparse_format, resolve_device
from .io import mmio
from .types import INDEX_DTYPE, TILE, SparseFormat, round_up

# the eight JAX Matrix leaves, in the JAX package's pytree order
LEAVES = ("row_ptr", "col_ind", "row_ind", "val",
          "col_ptr", "csc_row_ind", "csc_col_ind", "csc_val")


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


@dataclasses.dataclass
class Matrix:
    """Sparse matrix in dual CSR+CSC with padded edge arrays.

      row_ptr:  (nrows+1,) int32   CSR row pointers
      col_ind:  (nnz_pad,) int32   CSR column indices   (pad: 0)
      row_ind:  (nnz_pad,) int32   expanded COO row ids (pad: nrows)
      val:      (nnz_pad,) dtype   CSR values           (pad: 0)
      col_ptr / csc_row_ind / csc_col_ind / csc_val: the CSC mirror, None
        for CSRONLY, aliasing CSR when structurally symmetric
    """

    nrows: int
    ncols: int
    nvals: int
    row_ptr: Optional[torch.Tensor]
    col_ind: Optional[torch.Tensor]
    row_ind: Optional[torch.Tensor]
    val: Optional[torch.Tensor]
    col_ptr: Optional[torch.Tensor]
    csc_row_ind: Optional[torch.Tensor]
    csc_col_ind: Optional[torch.Tensor]
    csc_val: Optional[torch.Tensor]
    format: SparseFormat = SparseFormat.CSRCSC
    symmetric: bool = False
    _host_csr: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _host_csc: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- properties -----------------------------------------------------------
    @property
    def nnz_pad(self) -> int:
        arr = self.col_ind if self.col_ind is not None else self.csc_row_ind
        return int(arr.shape[0])

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return (self.val if self.val is not None else self.csc_val).dtype

    @property
    def device(self) -> torch.device:
        ptr = self.row_ptr if self.row_ptr is not None else self.col_ptr
        return ptr.device

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_coo(rows, cols, vals, nrows: int, ncols: int,
                 dtype: torch.dtype = torch.float32,
                 fmt: SparseFormat = None, pad_to: int = TILE,
                 device=None) -> "Matrix":
        """Build from COO triplets (reference: Matrix::build, matrix.hpp:126
        → sparse_matrix.hpp:291-351). Runs on "cuda" unless `device` says
        otherwise."""
        dev = resolve_device(device)
        if fmt is None:
            fmt = default_sparse_format()
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        nvals = len(rows)
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        np_dtype = _numpy_dtype(dtype)

        def pad_idx(a, fill):
            out = np.full(nnz_pad, fill, dtype=np.int32)
            out[:nvals] = a
            return out

        def pad_val(a):
            out = np.zeros(nnz_pad, dtype=np_dtype)
            out[:nvals] = a
            return out

        row_ptr_np, csr_cols, csr_vals = mmio.coo_to_csr(rows, cols, vals,
                                                         nrows)
        csr_rows = np.repeat(np.arange(nrows, dtype=np.int64),
                             np.diff(row_ptr_np))
        col_ptr_np, csc_rows, csc_vals = mmio.coo_to_csr(cols, rows, vals,
                                                         ncols)
        symmetric = (nrows == ncols
                     and np.array_equal(row_ptr_np, col_ptr_np)
                     and np.array_equal(csr_cols, csc_rows)
                     and np.array_equal(csr_vals, csc_vals))
        arrays = dict(row_ptr=row_ptr_np, col_ind=pad_idx(csr_cols, 0),
                      row_ind=pad_idx(csr_rows, nrows),
                      val=pad_val(csr_vals))
        if not symmetric and fmt != SparseFormat.CSRONLY:
            csc_cols = np.repeat(np.arange(ncols, dtype=np.int64),
                                 np.diff(col_ptr_np))
            arrays.update(col_ptr=col_ptr_np,
                          csc_row_ind=pad_idx(csc_rows, 0),
                          csc_col_ind=pad_idx(csc_cols, ncols),
                          csc_val=pad_val(csc_vals))
        if fmt == SparseFormat.CSCONLY:
            if symmetric:
                arrays.update(col_ptr=arrays["row_ptr"],
                              csc_row_ind=arrays["col_ind"],
                              csc_col_ind=arrays["row_ind"],
                              csc_val=arrays["val"])
            for k in LEAVES[:4]:
                arrays.pop(k)
        elif symmetric:
            # the aliased CSC comes for free, so a symmetric CSRONLY request
            # keeps both orientations, as in the JAX package
            fmt = SparseFormat.CSRCSC
        return Matrix._from_arrays(arrays, nrows, ncols, nvals, symmetric,
                                   fmt, dtype, dev)

    @staticmethod
    def from_numpy_arrays(arrays: dict, nrows: int, ncols: int, nvals: int,
                          symmetric: bool, dtype: torch.dtype = None,
                          device=None) -> "Matrix":
        """Carry a graph across from the JAX package: `arrays` maps the JAX
        Matrix leaves (`LEAVES`) to NumPy arrays, padded or not; a missing
        or None leaf means that orientation is absent."""
        dev = resolve_device(device)
        arrays = {k: np.asarray(v) for k, v in arrays.items()
                  if v is not None}
        has_csr = "row_ptr" in arrays
        has_csc = "col_ptr" in arrays or (symmetric and has_csr)
        if has_csr and has_csc:
            fmt = SparseFormat.CSRCSC
        else:
            fmt = SparseFormat.CSRONLY if has_csr else SparseFormat.CSCONLY
        if dtype is None:
            vals = arrays.get("val", arrays.get("csc_val"))
            dtype = torch.from_numpy(vals[:0].copy()).dtype
        return Matrix._from_arrays(arrays, nrows, ncols, nvals, symmetric,
                                   fmt, dtype, dev)

    @staticmethod
    def _from_arrays(arrays, nrows, ncols, nvals, symmetric, fmt, dtype,
                     dev) -> "Matrix":
        def put(key):
            a = arrays.get(key)
            if a is None:
                return None
            t = torch.from_numpy(np.array(a))   # a writable copy
            t = t.to(dtype) if key.endswith("val") else t.to(INDEX_DTYPE)
            return t.to(dev)

        t = {k: put(k) for k in LEAVES}
        if symmetric and t["row_ptr"] is not None:
            t.update(col_ptr=t["row_ptr"], csc_row_ind=t["col_ind"],
                     csc_col_ind=t["row_ind"], csc_val=t["val"])
            arrays = dict(arrays, col_ptr=arrays["row_ptr"],
                          csc_row_ind=arrays["col_ind"],
                          csc_val=arrays["val"])
        if fmt == SparseFormat.CSCONLY:
            t.update(row_ptr=None, col_ind=None, row_ind=None, val=None)

        def host(ptr_key, ind_key, val_key):
            if t[ptr_key] is None:
                return None
            ptr = np.asarray(arrays[ptr_key], np.int64)
            return (ptr, np.asarray(arrays[ind_key][:nvals], np.int32),
                    np.asarray(arrays[val_key][:nvals]))

        return Matrix(nrows, ncols, nvals, **t, format=fmt,
                      symmetric=symmetric,
                      _host_csr=host("row_ptr", "col_ind", "val"),
                      _host_csc=host("col_ptr", "csc_row_ind", "csc_val"))

    @staticmethod
    def from_mtx(path: str, directed: int = 0,
                 dtype: torch.dtype = torch.float32, use_cache: bool = True,
                 device=None, **kw) -> "Matrix":
        """readMtx + build with npz sidecar caching (reference:
        util.hpp:364-430 + sparse_matrix.hpp:328-407 .bin cache)."""
        resolve_device(device)   # raise before parsing when CUDA is missing
        if use_cache:
            from .io.cache import read_mtx_cached

            rows, cols, vals, nrows, ncols = read_mtx_cached(path, directed)
        else:
            rows, cols, vals, nrows, ncols, _ = mmio.read_mtx(
                path, directed=directed)
        return Matrix.from_coo(rows, cols, vals, nrows, ncols, dtype=dtype,
                               device=device, **kw)

    def pull_csr(self, transpose: bool = False) -> tuple:
        """(n_out, n_in, ptr, ind, val) of one pull orientation: the CSR for
        the mxv pull (y = A·x), the CSC for the vxm pull (transpose=True,
        y = Aᵀ·x). ptr is None when A lacks that orientation."""
        if transpose:
            return (self.ncols, self.nrows, self.col_ptr, self.csc_row_ind,
                    self.csc_val)
        return self.nrows, self.ncols, self.row_ptr, self.col_ind, self.val

    # -- host-side extraction -------------------------------------------------
    def host_csr(self):
        """(row_ptr int64, col_ind int32, val) of the stored entries, on the
        host: the kept copy where there is one, else fetched; None without
        a CSR."""
        if self._host_csr is not None:
            return self._host_csr
        return self._fetch(self.row_ptr, self.col_ind, self.val)

    def host_csc(self):
        """(col_ptr int64, csc_row_ind int32, csc_val), as host_csr."""
        if self._host_csc is not None:
            return self._host_csc
        return self._fetch(self.col_ptr, self.csc_row_ind, self.csc_val)

    def extract_tuples(self):
        """(rows int64, cols int64, vals) of the stored entries on the host,
        in CSR order (reference: matrix.hpp:171-194), from the host CSR."""
        if self.row_ptr is None:
            raise ValueError("extract_tuples reads the CSR; this Matrix is "
                             "CSC-only")
        ptr, ind, val = self.host_csr()
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(ptr))
        return rows, ind.astype(np.int64), val

    def _fetch(self, ptr, ind, val):
        if ptr is None:
            return None
        return (ptr.cpu().numpy().astype(np.int64),
                ind[: self.nvals].cpu().numpy(),
                val[: self.nvals].cpu().numpy())

    def __repr__(self):
        return (f"Matrix({self.nrows}x{self.ncols}, nvals={self.nvals}, "
                f"dtype={self.dtype}, fmt={self.format.name}, "
                f"sym={self.symmetric}, device={self.device})")
