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


# entries of one chunk of the build's passes: a pass's temporaries are a
# few tens of bytes an entry of one chunk, whatever the edge count
_CHUNK = 1 << 24
_INDEX_MAX = torch.iinfo(INDEX_DTYPE).max


def _chunks(m: int):
    return ((s, min(s + _CHUNK, m)) for s in range(0, m, _CHUNK))


def _check_index_range(nrows: int, ncols: int, nvals: int) -> None:
    """The leaves hold ids, pointers and sentinels as int32: raise past
    2^31 - 1."""
    if max(nrows, ncols, nvals) > _INDEX_MAX:
        raise ValueError(f"{nrows}x{ncols} with {nvals} entries: the "
                         f"index arrays are int32, at most {_INDEX_MAX}")


def _padded(a, nnz_pad: int, dtype: torch.dtype, device,
            bound: int = None):
    """A new (nnz_pad,) buffer of `dtype` on `device` holding the NumPy
    array or tensor `a` and zeros after it, copied a chunk at a time.

    With `bound`, `a` holds ids. Where they are int64, which the copy into
    int32 would wrap onto ids inside the shape, each chunk is held to [0,
    bound) before its copy: a NumPy array raises here, and a tensor's
    verdict comes back as a 0-d bool on its device, for `_build` to read
    with its order test. Returns (the buffer, that verdict or None)."""
    out = torch.zeros(nnz_pad, dtype=dtype, device=device)
    wide = bound is not None and (
        a.dtype == np.int64 if isinstance(a, np.ndarray)
        else a.dtype == torch.int64)
    ok = None
    if wide and isinstance(a, torch.Tensor):
        ok = torch.ones((), dtype=torch.bool, device=a.device)
    for s, e in _chunks(a.shape[0]):
        piece = a[s:e]
        if isinstance(piece, np.ndarray):
            if wide and (piece.min() < 0 or piece.max() >= bound):
                raise ValueError(f"ids outside [0, {bound})")
            piece = torch.from_numpy(piece)
        elif wide:
            ok &= ((piece >= 0) & (piece < bound)).all()
        out[s:e].copy_(piece)
    return out, ok


def _ascending(major: torch.Tensor, minor: torch.Tensor,
               m: int) -> torch.Tensor:
    """0-d bool: whether the first m (major, minor) pairs are in (major,
    minor) order, equal pairs allowed; compared as int32, neighbour by
    neighbour."""
    ok = torch.ones((), dtype=torch.bool, device=major.device)
    for s, e in _chunks(m - 1):
        a, b = major[s:e], major[s + 1:e + 1]
        ok &= ((a < b) | ((a == b) & (minor[s:e] <= minor[s + 1:e + 1]))
               ).all()
    return ok


def _equal(a: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """0-d bool: a[:m] == b[:m] everywhere (NaN equal to nothing)."""
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for s, e in _chunks(m):
        ok &= (a[s:e] == b[s:e]).all()
    return ok


def _ptr(major: torch.Tensor, m: int, n_major: int) -> torch.Tensor:
    """int64 (n_major + 1,) pointers of the first m major ids; raises on an
    id outside [0, n_major)."""
    counts = torch.bincount(major[:m], minlength=n_major)
    if counts.shape[0] > n_major:
        raise ValueError(f"ids outside [0, {n_major})")
    ptr = torch.zeros(n_major + 1, dtype=torch.int64, device=major.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr


def _stable_by(key: torch.Tensor, n_keys: int, m: int, srcs: tuple) -> tuple:
    """The first m entries of key and of each tensor in srcs, stably
    reordered by key (int32 ids in [0, n_keys)), as np.argsort(key[:m],
    kind="stable") orders them: a counting sort, a chunk of _CHUNK entries
    at a time (one stable int32 sort of the chunk ranks its equal keys),
    each entry scattered to its place in new buffers of key's length.
    Returns (ptr int32 (n_keys + 1,), the sorted keys padded with n_keys,
    the reordered srcs padded with 0)."""
    dev = key.device
    ptr = _ptr(key, m, n_keys)
    nxt = ptr[:-1].clone()
    keys_out = torch.full_like(key, n_keys)
    outs = [torch.zeros_like(s) for s in srcs]
    for s, e in _chunks(m):
        sk, order = torch.sort(key[s:e], stable=True)
        first = torch.searchsorted(sk, sk)
        sk_long = sk.long()
        base = nxt[sk_long]
        dest = base + (torch.arange(e - s, device=dev) - first)
        # every entry of a key writes the same next free slot
        nxt[sk_long] = base + (torch.searchsorted(sk, sk, right=True) - first)
        del first, base
        keys_out[dest] = sk
        order += s
        for src, out in zip(srcs, outs):
            out[dest] = src[order]
    return ptr.to(INDEX_DTYPE), keys_out, outs


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
                 device=None, steps=None) -> "Matrix":
        """Build from COO triplets (reference: Matrix::build, matrix.hpp:126
        → sparse_matrix.hpp:291-351): the ids are copied to the device as
        int32 and the values in their own dtype, each straight into a
        padded buffer, built there as `from_device_coo` builds, and the
        result keeps host copies of its CSR and CSC, as the JAX package's
        does. Runs on "cuda" unless `device` says otherwise. `steps`, when
        given, is called with each step's name as the step ends
        (utils.profiling.MemorySteps records the card's memory by step)."""
        dev = resolve_device(device)
        steps = steps or (lambda name: None)

        def host(a, ids):
            a = np.ascontiguousarray(a)
            if ids and a.dtype not in (np.int32, np.int64):
                a = a.astype(np.int64)
            return a

        rows, cols, vals = host(rows, True), host(cols, True), host(vals,
                                                                    False)
        nvals = len(rows)
        _check_index_range(nrows, ncols, nvals)
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        bufs = [_padded(rows, nnz_pad, INDEX_DTYPE, dev, nrows)[0],
                _padded(cols, nnz_pad, INDEX_DTYPE, dev, ncols)[0],
                _padded(vals, nnz_pad, torch.from_numpy(vals[:0]).dtype,
                        dev)[0]]
        steps("copy")
        M = Matrix._build(bufs, nvals, nrows, ncols, dtype, fmt, steps)
        M.host_csr()
        M.host_csc()
        steps("host copies")
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
        lengths, the CSC by a stable counting sort of the CSR by column
        (`_stable_by`), as `from_device_coo` builds its second orientation.
        `nvals` defaults to row_ptr[-1], the one value read on the host.
        The host copies are fetched at the first host_csr() / host_csc().
        Pads as `from_coo`: col_ind and csc_row_ind 0, row_ind nrows,
        csc_col_ind ncols, values 0."""
        dev = row_ptr.device
        row_ptr = row_ptr.to(INDEX_DTYPE)
        if nvals is None:
            nvals = int(row_ptr[-1])
        _check_index_range(nrows, ncols, nvals)
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        live = torch.arange(nnz_pad, device=dev) < nvals

        def pad_dev(a, fill):
            a = a[:nnz_pad]
            if a.shape[0] < nnz_pad:
                a = torch.cat([a, a.new_full((nnz_pad - a.shape[0],), fill)])
            return torch.where(live, a, fill)

        col_ind = pad_dev(col_ind.to(INDEX_DTYPE), 0)
        val = pad_dev(val, 0)
        row_ind = torch.full((nnz_pad,), nrows, dtype=INDEX_DTYPE,
                             device=dev)
        row_ind[:nvals] = torch.repeat_interleave(
            torch.arange(nrows, dtype=INDEX_DTYPE, device=dev),
            (row_ptr[1:] - row_ptr[:-1]).long(), output_size=nvals)
        csc = dict(col_ptr=None, csc_row_ind=None, csc_col_ind=None,
                   csc_val=None)
        fmt = SparseFormat.CSRONLY
        if build_csc:
            col_ptr, csc_cols, (csc_rows, csc_vals) = _stable_by(
                col_ind, ncols, nvals, (row_ind, val))
            csc = dict(col_ptr=col_ptr, csc_row_ind=csc_rows,
                       csc_col_ind=csc_cols, csc_val=csc_vals)
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
        the edges: the same arrays, format and symmetric flag as the JAX
        package's `from_coo`, duplicate triplets kept in their order, as
        its stable lexsorts keep them. The triplets are copied into padded
        buffers (ids int32) and built by `_build`. The host copies are
        fetched at the first host_csr() / host_csc()."""
        dtype = dtype or vals.dtype
        nvals = int(rows.shape[0])
        _check_index_range(nrows, ncols, nvals)
        nnz_pad = max(round_up(max(nvals, 1), pad_to), pad_to)
        dev = rows.device
        r, r_ok = _padded(rows, nnz_pad, INDEX_DTYPE, dev, nrows)
        c, c_ok = _padded(cols, nnz_pad, INDEX_DTYPE, dev, ncols)
        bufs = [r, c, _padded(vals, nnz_pad, vals.dtype, dev)[0]]
        del r, c   # `_build` frees each buffer once no orientation holds it
        return Matrix._build(bufs, nvals, nrows, ncols, dtype, fmt,
                             lambda name: None, ids_ok=(r_ok, c_ok))

    @staticmethod
    def _build(bufs: list, nvals: int, nrows: int, ncols: int,
               dtype: torch.dtype, fmt: SparseFormat, steps,
               ids_ok: tuple = (None, None)) -> "Matrix":
        """The Matrix of the triplets in `bufs` = [rows, cols, vals], each
        a padded buffer on the device (ids int32, pads 0, the values in
        their own dtype) with the triplets in its first nvals entries. The
        list is emptied, so that each buffer is freed once no orientation
        holds it. `ids_ok` holds `_padded`'s verdicts on int64 row and
        column ids (None where there was nothing to hold), read with the
        order test.

        One test, read on the host with the order test of the other
        orientation, finds whether the triplets are already in (col, row)
        order, as `io.mmio.canonicalize_coo` gives them, or in (row, col)
        order: such an orientation takes the buffers as they are, since a
        stable sort of a sorted sequence is the identity. Any other input
        is put in CSC order by two stable counting sorts, by row and then
        by column. The other orientation comes from the first by one
        stable counting sort by its minor ids (`_stable_by`): equal keys
        keep the first orientation's order, which is (major, minor, input)
        order. The symmetry test (CSR and CSC arrays equal, values in
        their own dtype; read on the host) runs with both orientations
        built; a symmetric Matrix keeps one set and aliases the other. The
        values are cast to `dtype` last. Peaks at about 24 B an edge for
        float32 values, the two orientations' 12 B each, beside a chunk's
        temporaries."""
        if fmt is None:
            fmt = default_sparse_format()
        rows, cols, vals = bufs
        m = nvals
        held = [(ok, bound) for ok, bound in zip(ids_ok, (nrows, ncols))
                if ok is not None]
        verdicts = torch.stack(
            [_ascending(cols, rows, m), _ascending(rows, cols, m)]
            + [ok for ok, _ in held]).tolist()
        csc_sorted, csr_sorted = verdicts[:2]
        for in_shape, (_, bound) in zip(verdicts[2:], held):
            if not in_shape:
                raise ValueError(f"ids outside [0, {bound})")
        steps("order test")
        bufs.clear()
        if csc_sorted:
            cols[m:] = ncols
            csc = (_ptr(cols, m, ncols).to(INDEX_DTYPE), rows, cols, vals)
        elif csr_sorted:
            rows[m:] = nrows
            csr = (_ptr(rows, m, nrows).to(INDEX_DTYPE), cols, rows, vals)
        else:
            _, rows, (cols, vals) = _stable_by(rows, nrows, m, (cols, vals))
            col_ptr, cols, (rows, vals) = _stable_by(cols, ncols, m,
                                                     (rows, vals))
            csc = (col_ptr, rows, cols, vals)
            steps("csc")
        del rows, cols, vals   # the orientations alone hold the buffers
        if csc_sorted or not csr_sorted:
            row_ptr, row_ind, (col_ind, val) = _stable_by(
                csc[1], nrows, m, (csc[2], csc[3]))
            csr = (row_ptr, col_ind, row_ind, val)
            steps("csr")
        else:
            col_ptr, csc_col_ind, (csc_row_ind, csc_val) = _stable_by(
                csr[1], ncols, m, (csr[2], csr[3]))
            csc = (col_ptr, csc_row_ind, csc_col_ind, csc_val)
            steps("csc")
        symmetric = nrows == ncols and bool(
            (csr[0] == csc[0]).all() & _equal(csr[1], csc[1], m)
            & _equal(csr[3], csc[3], m))
        steps("symmetry test")
        if symmetric:
            csc = csr
        # the tuples hold (ptr, minor ids, major ids, values): the leaves'
        # order within each orientation
        t = dict(zip(LEAVES, csr + (None,) * 4))
        if symmetric or fmt != SparseFormat.CSRONLY:
            t.update(zip(LEAVES[4:], csc))
        del csr, csc
        if fmt == SparseFormat.CSCONLY:
            t.update(row_ptr=None, col_ind=None, row_ind=None, val=None)
        elif symmetric:
            # the aliased CSC comes for free, so a symmetric CSRONLY request
            # keeps both orientations, as in the JAX package
            fmt = SparseFormat.CSRCSC
        for side in ("val", "csc_val"):
            if t[side] is not None:
                t[side] = t[side].to(dtype)
        if symmetric and t["val"] is not None:
            t["csc_val"] = t["val"]
        steps("cast")
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
        """(col_ptr int64, csc_row_ind int32, csc_val), as host_csr. A
        symmetric Matrix with both orientations gives the host CSR's
        arrays, which are equal to it, instead of fetching a second copy."""
        if self._host_csc is None:
            if self.symmetric and self.col_ptr is not None \
                    and self.row_ptr is not None:
                self._host_csc = self.host_csr()
            else:
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
