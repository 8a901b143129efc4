"""Matrix Market I/O with graphblast-compatible preprocessing (counterpart
of graphblast_tpu/io/mmio.py, NumPy only).

Semantics of the reference's MTX ingestion pipeline:
  * banner/size parsing          (reference: graphblas/mmio.hpp:1-333)
  * readMtx symmetric doubling + directedness forcing (util.hpp:364-430)
  * removeSelfloop: self-loop removal + duplicate dedup (util.hpp:263-329)
  * customSort: column-major (col, row) sort (util.hpp:170-195)
  * coo2csr conversion (util.hpp:501-559)
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

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
    170-195)."""
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

