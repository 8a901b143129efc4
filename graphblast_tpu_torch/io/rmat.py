"""RMAT / Graph500 Kronecker graph generator and 2D grids (counterpart of
graphblast_tpu/io/rmat.py).

`rmat_edges` draws the same NumPy random stream as the JAX package, so one
(scale, edge_factor, seed) gives the same COO arrays in both.

From scale CACHE_MIN_SCALE (20) on, `rmat_matrix` keeps the canonicalized
COO of an undirected graph on disk, as the JAX package does: generating and
canonicalizing RMAT 22 takes minutes on the host, reading it back seconds.
The file is `.rmat{scale}_{edge_factor}_{seed}.torch.npz` (int32 rows and
cols, float32 vals) in `cache_dir`, else GRB_RMAT_CACHE_DIR, else the
temporary directory (TMPDIR, /tmp where it is unset); GRB_RMAT_CACHE=0 turns the cache off. It is written to a temporary name and
renamed, so a reader never sees half a file, and the JAX package's file
(`.npz` without `.torch`) is never read. `python -m
graphblast_tpu_torch.tools.gen_rmat_cache 22 24` builds the files ahead.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .mmio import canonicalize_coo

# the least scale whose graph rmat_matrix caches (the JAX package's)
CACHE_MIN_SCALE = 20


def cache_path(scale: int, edge_factor: int, seed: int,
               cache_dir: str | None = None) -> str:
    """Where the canonicalized COO of rmat(scale, edge_factor, seed) is
    kept: `cache_dir`, else GRB_RMAT_CACHE_DIR, else the temporary
    directory (TMPDIR, /tmp where it is unset)."""
    d = cache_dir or os.environ.get("GRB_RMAT_CACHE_DIR",
                                    tempfile.gettempdir())
    return os.path.join(d, f".rmat{scale}_{edge_factor}_{seed}.torch.npz")


def save_coo(path: str, rows, cols, vals) -> None:
    """Write a cache file: int32 rows and cols, float32 vals, through a
    temporary file in the same directory and a rename."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, rows=np.asarray(rows).astype(np.int32),
                     cols=np.asarray(cols).astype(np.int32),
                     vals=np.asarray(vals, np.float32))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_coo(path: str):
    """(rows, cols, vals) of a cache file."""
    with np.load(path) as z:
        return z["rows"], z["cols"], z["vals"]


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """2^scale-vertex RMAT COO edges (m = edge_factor · 2^scale).

    Returns (rows, cols) int64 with vertex ids randomly permuted (Graph500
    shuffle); duplicates and self-loops are kept, canonicalize_coo drops
    them."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.RandomState(seed)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r_bit = rng.rand(m) > ab
        c_bit = np.where(r_bit, rng.rand(m) > c_norm, rng.rand(m) > a_norm)
        rows |= r_bit.astype(np.int64) << bit
        cols |= c_bit.astype(np.int64) << bit
    perm = rng.permutation(n)
    return perm[rows], perm[cols]


def grid_edges(side: int):
    """Undirected 2D 4-neighbor grid: n = side², diameter 2·(side−1).
    Returns symmetric (rows, cols)."""
    v = np.arange(side * side, dtype=np.int64).reshape(side, side)
    right = np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()])
    down = np.stack([v[:-1, :].ravel(), v[1:, :].ravel()])
    rows = np.concatenate([right[0], down[0], right[1], down[1]])
    cols = np.concatenate([right[1], down[1], right[0], down[0]])
    return rows, cols


def grid_matrix(side: int, dtype=torch.float32, device=None, **kw):
    """Canonicalized side×side grid Matrix (unit weights)."""
    from ..matrix import Matrix

    rows, cols = grid_edges(side)
    vals = np.ones(len(rows), np.float32)
    rows, cols, vals = canonicalize_coo(rows, cols, vals, undirected=False,
                                        remove_self_loops=True)
    n = side * side
    return Matrix.from_coo(rows, cols, vals, n, n, dtype=dtype, device=device,
                           **kw)


def rmat_matrix(scale: int, edge_factor: int = 16, seed: int = 0,
                undirected: bool = True, dtype=torch.float32, device=None,
                cache_dir: str | None = None, **kw):
    """Canonicalized Matrix from RMAT edges (weights 1.0). At scale 18,
    edge factor 16 and seed 42: n = 262,144, nnz = 7,610,284. From scale
    CACHE_MIN_SCALE on, an undirected graph's COO is read from its cache
    file where there is one, and written there where there is none (a
    directory that cannot be written is passed over); GRB_RMAT_CACHE=0
    turns this off."""
    from ..matrix import Matrix

    n = 1 << scale
    use_cache = (scale >= CACHE_MIN_SCALE and undirected
                 and os.environ.get("GRB_RMAT_CACHE", "1") != "0")
    cpath = cache_path(scale, edge_factor, seed, cache_dir) if use_cache \
        else None
    if cpath is not None and os.path.exists(cpath):
        rows, cols, vals = load_coo(cpath)
        return Matrix.from_coo(rows, cols, vals, n, n, dtype=dtype,
                               device=device, **kw)
    rows, cols = rmat_edges(scale, edge_factor, seed)
    vals = np.ones(len(rows), dtype=np.float32)
    rows, cols, vals = canonicalize_coo(rows, cols, vals,
                                        undirected=undirected,
                                        remove_self_loops=True)
    if cpath is not None:
        try:
            save_coo(cpath, rows, cols, vals)
        except OSError:
            pass
    return Matrix.from_coo(rows, cols, vals, n, n, dtype=dtype, device=device,
                           **kw)
