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
JAX package does, fetched at first use; `_plans` caches kernel plans per
pull orientation.
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


def _orient(major, minor, vals, n_major: int, n_minor: int) -> tuple:
    """The edges stably sorted by (major, minor), as np.lexsort((minor,
    major)) sorts them: (ptr int32 (n_major + 1,), the sorted minor ids and
    major ids as int32, the values in that order), on the edges' device."""
    major, minor = major.long(), minor.long()
    order = torch.sort(major * n_minor + minor, stable=True).indices
    sorted_major = major[order]
    ptr = torch.searchsorted(
        sorted_major, torch.arange(n_major + 1, device=major.device),
        out_int32=True)
    return (ptr, minor[order].to(INDEX_DTYPE), sorted_major.to(INDEX_DTYPE),
            vals[order])


def _pad(a: torch.Tensor, nnz_pad: int, fill,
         dtype: torch.dtype = INDEX_DTYPE) -> torch.Tensor:
    """a, cast to `dtype`, followed by `fill` up to nnz_pad entries."""
    out = torch.full((nnz_pad,), fill, dtype=dtype, device=a.device)
    out[: a.shape[0]] = a
    return out


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

    def has_csr(self) -> bool:
        return self.format in (SparseFormat.CSRCSC, SparseFormat.CSRONLY)

    def has_csc(self) -> bool:
        return self.format in (SparseFormat.CSRCSC, SparseFormat.CSCONLY)

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_coo(rows, cols, vals, nrows: int, ncols: int,
                 dtype: torch.dtype = torch.float32,
                 fmt: SparseFormat = None, pad_to: int = TILE,
                 device=None) -> "Matrix":
        """Build from COO triplets (reference: Matrix::build, matrix.hpp:126
        → sparse_matrix.hpp:291-351): the triplets are copied to the device
        and built there by `from_device_coo`, and the result keeps host
        copies of its CSR and CSC, as the JAX package's does. Runs on
        "cuda" unless `device` says otherwise."""
        dev = resolve_device(device)

        def put(a, np_dtype=None):
            return torch.from_numpy(np.array(a, dtype=np_dtype)).to(dev)

        M = Matrix.from_device_coo(put(rows, np.int64), put(cols, np.int64),
                                   put(vals), nrows, ncols, dtype=dtype,
                                   fmt=fmt, pad_to=pad_to)
        M.host_csr()
        M.host_csc()
        return M

    @staticmethod
    def from_numpy_arrays(arrays: dict, nrows: int, ncols: int, nvals: int,
                          symmetric: bool, dtype: torch.dtype = None,
                          device=None, fmt: SparseFormat = None) -> "Matrix":
        """Carry a graph across from the JAX package: `arrays` maps the JAX
        Matrix leaves (`LEAVES`) to NumPy arrays, padded or not; a missing
        or None leaf means that orientation is absent. `fmt` is the JAX
        Matrix's format; by default it follows the leaves (a symmetric CSR
        brings its aliased CSC). A CSRONLY `fmt` keeps a symmetric
        Matrix one-sided, as JAX's `set_storage` leaves it."""
        dev = resolve_device(device)
        arrays = {k: np.asarray(v) for k, v in arrays.items()
                  if v is not None}
        has_csr = "row_ptr" in arrays
        has_csc = "col_ptr" in arrays or (symmetric and has_csr)
        if fmt is None:
            if has_csr and has_csc:
                fmt = SparseFormat.CSRCSC
            else:
                fmt = (SparseFormat.CSRONLY if has_csr
                       else SparseFormat.CSCONLY)
        if dtype is None:
            vals = arrays.get("val", arrays.get("csc_val"))
            dtype = torch.from_numpy(vals[:0].copy()).dtype
        return Matrix._from_arrays(arrays, nrows, ncols, nvals, symmetric,
                                   fmt, dtype, dev)

    @staticmethod
    def from_device_csr(row_ptr: torch.Tensor, col_ind: torch.Tensor,
                        val: torch.Tensor, nrows: int, ncols: int,
                        nvals: int = None, build_csc: bool = True,
                        pad_to: int = TILE) -> "Matrix":
        """Build from CSR tensors on their device, with no host copy of the
        edges (reference: sparse_matrix.hpp:418-435, a build from raw
        device pointers): the expanded row ids by a repeat of the row
        lengths, the CSC as `from_device_coo` orients it (`_orient`).
        `nvals` defaults to row_ptr[-1], the one value read on the host.
        The host copies are fetched at the first host_csr() / host_csc().
        Pads as `from_coo`: col_ind and csc_row_ind 0, row_ind nrows,
        csc_col_ind ncols, values 0."""
        dev = row_ptr.device
        row_ptr = row_ptr.to(INDEX_DTYPE)
        if nvals is None:
            nvals = int(row_ptr[-1])
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        live = torch.arange(nnz_pad, device=dev) < nvals

        def pad_dev(a, fill):
            a = a[:nnz_pad]
            if a.shape[0] < nnz_pad:
                a = torch.cat([a, a.new_full((nnz_pad - a.shape[0],), fill)])
            return torch.where(live, a, fill)

        col_ind = pad_dev(col_ind.to(INDEX_DTYPE), 0)
        val = pad_dev(val, 0)
        rows = torch.repeat_interleave(
            torch.arange(nrows, dtype=INDEX_DTYPE, device=dev),
            (row_ptr[1:] - row_ptr[:-1]).long(), output_size=nvals)
        row_ind = _pad(rows, nnz_pad, nrows)
        csc = dict(col_ptr=None, csc_row_ind=None, csc_col_ind=None,
                   csc_val=None)
        fmt = SparseFormat.CSRONLY
        if build_csc:
            col_ptr, csc_rows, csc_cols, csc_vals = _orient(
                col_ind[:nvals], row_ind[:nvals], val[:nvals], ncols, nrows)
            csc = dict(col_ptr=col_ptr,
                       csc_row_ind=_pad(csc_rows, nnz_pad, 0),
                       csc_col_ind=_pad(csc_cols, nnz_pad, ncols),
                       csc_val=_pad(csc_vals, nnz_pad, 0, val.dtype))
            fmt = SparseFormat.CSRCSC
        return Matrix(nrows, ncols, nvals, row_ptr=row_ptr, col_ind=col_ind,
                      row_ind=row_ind, val=val, **csc, format=fmt,
                      symmetric=False)

    @staticmethod
    def from_device_coo(rows: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, nrows: int, ncols: int,
                        dtype: torch.dtype = None, fmt: SparseFormat = None,
                        pad_to: int = TILE) -> "Matrix":
        """Build from COO triplets on their device, with no host copy of
        the edges: each orientation by a stable sort of (major, minor) keys
        (`_orient`), so duplicate triplets keep their order, as the JAX
        package's stable lexsorts keep it; the same arrays, format and
        symmetric flag as the JAX package's `from_coo`. One value is read
        on the host, the symmetry test. The host copies are fetched at the
        first host_csr() / host_csc()."""
        if fmt is None:
            fmt = default_sparse_format()
        dtype = dtype or vals.dtype
        nvals = int(rows.shape[0])
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        row_ptr, csr_cols, csr_rows, csr_vals = _orient(rows, cols, vals,
                                                        nrows, ncols)
        col_ptr, csc_rows, csc_cols, csc_vals = _orient(cols, rows, vals,
                                                        ncols, nrows)
        symmetric = nrows == ncols and bool(
            (row_ptr == col_ptr).all() & (csr_cols == csc_rows).all()
            & (csr_vals == csc_vals).all())
        t = dict(row_ptr=row_ptr, col_ind=_pad(csr_cols, nnz_pad, 0),
                 row_ind=_pad(csr_rows, nnz_pad, nrows),
                 val=_pad(csr_vals, nnz_pad, 0, dtype),
                 col_ptr=None, csc_row_ind=None, csc_col_ind=None,
                 csc_val=None)
        if symmetric:
            t.update(col_ptr=t["row_ptr"], csc_row_ind=t["col_ind"],
                     csc_col_ind=t["row_ind"], csc_val=t["val"])
        elif fmt != SparseFormat.CSRONLY:
            t.update(col_ptr=col_ptr,
                     csc_row_ind=_pad(csc_rows, nnz_pad, 0),
                     csc_col_ind=_pad(csc_cols, nnz_pad, ncols),
                     csc_val=_pad(csc_vals, nnz_pad, 0, dtype))
        if fmt == SparseFormat.CSCONLY:
            t.update(row_ptr=None, col_ind=None, row_ind=None, val=None)
        elif symmetric:
            # the aliased CSC comes for free, so a symmetric CSRONLY request
            # keeps both orientations, as in the JAX package
            fmt = SparseFormat.CSRCSC
        return Matrix(nrows, ncols, nvals, **t, format=fmt,
                      symmetric=symmetric)

    @staticmethod
    def from_dense(dense, fmt: SparseFormat = SparseFormat.CSRCSC,
                   device=None) -> "Matrix":
        """The nonzeros of a 2-D array (NumPy, or a tensor, read on the
        host), of its dtype, built as `from_coo` builds."""
        if isinstance(dense, torch.Tensor):
            dense = dense.cpu().numpy()
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return Matrix.from_coo(rows, cols, dense[rows, cols], *dense.shape,
                               dtype=torch.from_numpy(dense[:0, :0]).dtype,
                               fmt=fmt, device=device)

    # -- reference API-shape methods (matrix.hpp:13-251) ----------------------
    def dup(self) -> "Matrix":
        """dup() (reference: matrix.hpp:96-105): a Matrix over the same
        tensors. No operation writes into a Matrix's tensors, so this is a
        copy in effect, in O(1)."""
        return dataclasses.replace(self, _plans={})

    def clear(self) -> "Matrix":
        """clear() (reference: matrix.hpp:107-112): no stored entries, the
        same shape, dtype, capacity and format."""
        def z(t):
            return None if t is None else torch.zeros_like(t)

        def sentinel(t, fill):
            return None if t is None else torch.full_like(t, fill)

        return Matrix(self.nrows, self.ncols, 0, row_ptr=z(self.row_ptr),
                      col_ind=z(self.col_ind),
                      row_ind=sentinel(self.row_ind, self.nrows),
                      val=z(self.val), col_ptr=z(self.col_ptr),
                      csc_row_ind=z(self.csc_row_ind),
                      csc_col_ind=sentinel(self.csc_col_ind, self.ncols),
                      csc_val=z(self.csc_val), format=self.format,
                      symmetric=False)

    def fill(self, value) -> "Matrix":
        """fill() (reference: matrix.hpp:232-238): every padded value slot
        set to `value`, as the JAX package's full_like sets it."""
        def full(t):
            return None if t is None else torch.full_like(t, value)

        return dataclasses.replace(self, val=full(self.val),
                                   csc_val=full(self.csc_val),
                                   _host_csr=None, _host_csc=None,
                                   _plans={})

    def set_storage(self, fmt: SparseFormat) -> "Matrix":
        """setStorage (reference: matrix.hpp:150-156): narrow to one
        orientation, dropping the other's tensors, or keep both. Widening a
        symmetric Matrix aliases the CSR; widening any other one-sided
        Matrix rebuilds it from its entries."""
        if fmt == self.format:
            return self
        if fmt == SparseFormat.CSRONLY:
            return dataclasses.replace(
                self, col_ptr=None, csc_row_ind=None, csc_col_ind=None,
                csc_val=None, format=fmt, _host_csc=None, _plans={})
        if fmt == SparseFormat.CSCONLY:
            return dataclasses.replace(
                self, row_ptr=None, col_ind=None, row_ind=None, val=None,
                format=fmt, _host_csr=None, _plans={})
        if self.symmetric and self.has_csr():
            return dataclasses.replace(
                self, col_ptr=self.row_ptr, csc_row_ind=self.col_ind,
                csc_col_ind=self.row_ind, csc_val=self.val, format=fmt,
                _host_csc=self._host_csr, _plans={})
        r, c, v = self.extract_tuples()
        return Matrix.from_coo(r, c, v, self.nrows, self.ncols,
                               dtype=self.dtype, fmt=fmt, device=self.device)

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
        elif fmt == SparseFormat.CSRONLY:
            t.update(col_ptr=None, csc_row_ind=None, csc_col_ind=None,
                     csc_val=None)

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
        host: fetched at the first call and kept (no operation writes into
        a Matrix's tensors); None without a CSR."""
        if self._host_csr is None:
            self._host_csr = self._fetch(self.row_ptr, self.col_ind,
                                         self.val)
        return self._host_csr

    def host_csc(self):
        """(col_ptr int64, csc_row_ind int32, csc_val), as host_csr."""
        if self._host_csc is None:
            self._host_csc = self._fetch(self.col_ptr, self.csc_row_ind,
                                         self.csc_val)
        return self._host_csc

    def extract_tuples(self):
        """(rows int64, cols int64, vals) of the stored entries on the host,
        in CSR order (reference: matrix.hpp:171-194), from the host CSR; a
        CSC-only Matrix gives its entries in CSC order."""
        if self.row_ptr is None:
            ptr, ind, val = self.host_csc()
            cols = np.repeat(np.arange(self.ncols, dtype=np.int64),
                             np.diff(ptr))
            return ind.astype(np.int64), cols, val
        ptr, ind, val = self.host_csr()
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(ptr))
        return rows, ind.astype(np.int64), val

    def to_dense(self) -> np.ndarray:
        """The (nrows, ncols) NumPy array of the stored entries, on the
        host; a duplicate entry's last slot wins, as in the JAX package."""
        out = np.zeros((self.nrows, self.ncols), dtype=_numpy_dtype(
            self.dtype))
        r, c, v = self.extract_tuples()
        out[r, c] = v
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        r, c, v = self.extract_tuples()
        return sp.csr_matrix((v, (r, c)), shape=self.shape)

    def check(self) -> bool:
        """The CSR's invariants, on the host (reference:
        sparse_matrix.hpp:521-551): row_ptr from 0 to nvals and monotone,
        column ids in bounds, the sentinel nrows in every pad slot of
        row_ind. Raises ValueError."""
        rp = self.row_ptr.cpu().numpy()
        if rp[0] != 0 or rp[-1] != self.nvals:
            raise ValueError("row_ptr endpoints")
        if np.any(np.diff(rp) < 0):
            raise ValueError("row_ptr monotone")
        ci = self.col_ind[: self.nvals].cpu().numpy()
        if ci.min(initial=0) < 0 or (self.nvals
                                     and ci.max(initial=0) >= self.ncols):
            raise ValueError("column ids in bounds")
        if np.any(self.row_ind[self.nvals:].cpu().numpy() != self.nrows):
            raise ValueError("pad sentinel")
        return True

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
