"""Matrix Market I/O with graphblast-compatible preprocessing (counterpart
of graphblast_tpu/io/mmio.py).

Semantics of the reference's MTX ingestion pipeline:
  * banner/size parsing          (reference: graphblas/mmio.hpp:1-333)
  * readMtx symmetric doubling + directedness forcing (util.hpp:364-430)
  * removeSelfloop: self-loop removal + duplicate dedup (util.hpp:263-329)
  * customSort: column-major (col, row) sort (util.hpp:170-195)
  * coo2csr conversion (util.hpp:501-559), coo2csc (util.hpp:562-572)
  * write_mtx, the MatrixMarket writer (a file byte-equal to the JAX
    package's writer's)

The NumPy code here is the semantic ground truth. The native C++ runtime
(graphblast_tpu_torch/native, built with g++ at its first use) takes the
same pipeline where the JAX package sends it: every .mtx parse, and
canonicalize_coo and coo_to_csr from 2^20 entries on. Its arrays equal the
NumPy path's. GRB_NATIVE=0 turns it off.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# canonicalize_coo and coo_to_csr take the native route from this many
# entries on, as the JAX package's do
NATIVE_MIN = 1 << 20

_REMOVE_SELFLOOP = os.environ.get("GRB_UTIL_REMOVE_SELFLOOP", "1") not in (
    "0", "false", "False")


@dataclass
class MtxInfo:
    object: str
    format: str    # coordinate | array
    field: str     # real | integer | pattern | complex
    symmetry: str  # general | symmetric | skew-symmetric | hermitian

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"


def read_banner(line: str) -> MtxInfo:
    """Parse '%%MatrixMarket object format field symmetry'."""
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"bad MatrixMarket banner: {line!r}")
    return MtxInfo(parts[1].lower(), parts[2].lower(), parts[3].lower(),
                   parts[4].lower())


def read_mtx(path: str, directed: int = 0,
             remove_self_loops: bool | None = None):
    """Read an .mtx file into canonical COO.

    directed: 0 = honor the mtx symmetry flag; 1 = force directed (no
    doubling); 2 = force undirected (double edges) (reference:
    util.hpp:360-364).

    Returns (rows, cols, vals, nrows, ncols, info): COO sorted column-major,
    self-loops removed (unless GRB_UTIL_REMOVE_SELFLOOP=0), duplicates
    dropped (first kept), symmetric inputs doubled, pattern values 1.0.
    """
    if remove_self_loops is None:
        remove_self_loops = _REMOVE_SELFLOOP
    with open(path, "r") as f:
        info = read_banner(f.readline())

    from ..native import read_mtx_native

    nat = read_mtx_native(path, directed, remove_self_loops)
    if nat is not None:
        return (*nat, info)

    with open(path, "r") as f:
        f.readline()
        if info.format != "coordinate":
            raise NotImplementedError(
                "array-format mtx not supported (matches reference)")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nvals = (int(x) for x in line.split())
        data = (np.loadtxt(f, ndmin=2, dtype=np.float64, max_rows=nvals)
                if nvals else np.zeros((0, 3)))

    if data.shape[0] != nvals:
        raise ValueError(f"expected {nvals} entries, got {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    cols = data[:, 1].astype(np.int64) - 1
    if info.is_pattern or data.shape[1] < 3:
        vals = np.ones(nvals, dtype=np.float64)
    else:
        vals = data[:, 2].astype(np.float64)

    undirected = info.is_symmetric or directed == 2
    if directed == 1:
        undirected = False
    rows, cols, vals = canonicalize_coo(rows, cols, vals, undirected=undirected,
                                        remove_self_loops=remove_self_loops)
    return rows, cols, vals, nrows, ncols, info


def canonicalize_coo(rows, cols, vals, *, undirected: bool,
                     remove_self_loops: bool):
    """Symmetric doubling + self-loop/dup removal + col-major sort.

    Doubling appends (c, r) for every off-diagonal (r, c); duplicates keep
    the first occurrence in (col, row) order (reference: util.hpp:263-329,
    170-195). From NATIVE_MIN entries on, the native runtime does it."""
    if len(rows) >= NATIVE_MIN:
        from ..native import canonicalize_native

        out = canonicalize_native(rows, cols, vals, undirected,
                                  remove_self_loops)
        if out is not None:
            r, c, v = out
            return r, c, v.astype(np.asarray(vals).dtype, copy=False)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if undirected:
        off_diag = rows != cols
        rows, cols = (np.concatenate([rows, cols[off_diag]]),
                      np.concatenate([cols, rows[off_diag]]))
        vals = np.concatenate([vals, vals[off_diag]])

    order = np.lexsort((rows, cols))   # primary key col, secondary row
    rows, cols, vals = rows[order], cols[order], vals[order]

    keep = np.ones(len(rows), dtype=bool)
    if remove_self_loops:
        keep &= rows != cols
    if len(rows) > 1:
        keep[1:] &= ~((rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1]))
    return rows[keep], cols[keep], vals[keep]


def coo_to_csr(rows, cols, vals, nrows: int, ncols: int | None = None):
    """COO -> CSR (reference: util.hpp:501-559 coo2csr): (row_ptr int64,
    cols, vals), each row's entries sorted by column. The input need not
    be sorted. From NATIVE_MIN entries on, the native radix runtime does
    it."""
    if len(rows) >= NATIVE_MIN:
        from ..native import coo_to_csr_native

        ncols_eff = ncols if ncols is not None else (
            int(cols.max()) + 1 if len(cols) else 0)
        out = coo_to_csr_native(rows, cols, vals, nrows, max(ncols_eff, 1))
        if out is not None:
            ptr, c, v = out
            return ptr, c, v.astype(np.asarray(vals).dtype, copy=False)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    return np.cumsum(row_ptr), cols.copy(), vals.copy()


def coo_to_csc(rows, cols, vals, ncols: int):
    """COO -> CSC (reference: util.hpp:562-572, coo2csc = coo2csr on the
    swapped ids): (col_ptr int64, row ids, vals), each column's entries
    sorted by row."""
    return coo_to_csr(cols, rows, vals, ncols)


def write_mtx(path, rows, cols, vals, nrows, ncols, field="real",
              symmetry="general", chunk: int = 1 << 22):
    """Write COO (0-based ids) to a MatrixMarket coordinate file: the
    banner, the size line, one 1-based entry a line (`field` "pattern":
    ids only, `vals` unread; else "%d %d %.9g"), chunk entries at a time
    through np.savetxt, so multi-GB files write at C-loop speed."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    m = len(rows)
    with open(path, "wb") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n"
                .encode())
        f.write(f"{nrows} {ncols} {m}\n".encode())
        for s in range(0, m, chunk):
            t = min(s + chunk, m)
            if field == "pattern":
                np.savetxt(f, np.column_stack([rows[s:t] + 1, cols[s:t] + 1]),
                           fmt="%d %d")
            else:
                np.savetxt(
                    f, np.column_stack([(rows[s:t] + 1).astype(np.float64),
                                        (cols[s:t] + 1).astype(np.float64),
                                        np.asarray(vals)[s:t]]),
                    fmt="%d %d %.9g")
