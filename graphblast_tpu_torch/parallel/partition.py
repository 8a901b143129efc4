"""The 1D graph partition (counterpart of graphblast_tpu/parallel/
partition.py:121-308).

Over a mesh of P ranks, rank k owns
  * ROW block k: the CSR of rows [k·rows_per, (k+1)·rows_per) with GLOBAL
    column ids, the push side of vxm and the pull side of mxv;
  * COLUMN block k: the CSC of those columns with GLOBAL row ids, the pull
    side of vxm;
  * vertex block k of every vector.
rows_per = round_up(n, 8·P) / P and n_pad = P · rows_per, as in the JAX
package. The JAX package stacks all P blocks with a leading axis and pads
their edge arrays to one capacity; here each rank builds and holds its own
block only, padded to the same capacity (the most edges of any block,
rounded up to `pad_edges_to`) with the same n_pad sentinel and int32
pointers, so rank k's arrays equal the JAX leaves' row k bit for bit
(`ShardedMatrix.from_jax_arrays` carries those across). The compute reads
each block through `csr()` / `csc()`, cut at its true edge count: the
sentinel, one past the gathered x, reaches no kernel.

The per-block plans take the place of the JAX package's stacked Pallas
plans: the bitmap pull K1's over the column block (`pull_plan`, for BFS)
and the value pull's (`value_pull_plan`, for PageRank), both with
n_out = rows_per, n_in = n_pad and the block's one RowSchedule, which the
min/max pulls (S) over the block read too. Each is built at its first use
and kept, as the schedule is, so every distributed pull on the card runs
on its kernel, whoever built the partition.

`partition_cached` keeps each rank's block arrays in an npz beside the
graph, one file a rank, and loads them on the next run of the same graph
over the same number of ranks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io import mmio
from ..matrix import Matrix, _numpy_dtype
from ..ops.kernels.bitmap_pull import BitmapPlan, build_plan_bitmap
from ..ops.kernels.row_schedule import RowSchedule, build_schedule
from ..ops.kernels.value_pull import ValuePlan, build_plan
from ..types import round_up
from .bootstrap import AXIS, mesh_device

LEAVES = ("csr_ptr", "csr_ind", "csr_val", "csc_ptr", "csc_ind", "csc_val")


@dataclasses.dataclass(eq=False)
class ShardedMatrix:
    """Rank `rank`'s blocks of a 1D-partitioned square matrix.

      csr_ptr (rows_per+1,) int32 local row pointers
      csr_ind (cap,) int32        GLOBAL column ids (pad: the n_pad sentinel)
      csr_val (cap,)
      csc_ptr / csc_ind / csc_val: the column block, GLOBAL row ids
    n is the true vertex count, nvals the whole matrix's edge count."""

    n: int
    n_pad: int
    P: int
    rows_per: int
    nvals: int
    rank: int
    csr_ptr: torch.Tensor
    csr_ind: torch.Tensor
    csr_val: torch.Tensor
    csc_ptr: torch.Tensor
    csc_ind: torch.Tensor
    csc_val: torch.Tensor
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.csr_val.dtype

    @property
    def device(self) -> torch.device:
        return self.csr_ptr.device

    @property
    def gids(self) -> torch.Tensor:
        """The global ids of this rank's vertex block, int32."""
        if "gids" not in self._cache:
            self._cache["gids"] = self.rank * self.rows_per + torch.arange(
                self.rows_per, dtype=torch.int32, device=self.device)
        return self._cache["gids"]

    def _edges(self, transpose: bool) -> int:
        key = "csc/m" if transpose else "csr/m"
        if key not in self._cache:
            ptr = self.csc_ptr if transpose else self.csr_ptr
            self._cache[key] = int(ptr[-1])
        return self._cache[key]

    def csr(self) -> tuple:
        """(ptr, ind, val) of the row block, ind and val cut at its edge
        count."""
        m = self._edges(False)
        return self.csr_ptr, self.csr_ind[:m], self.csr_val[:m]

    def csc(self) -> tuple:
        """(ptr, ind, val) of the column block, cut at its edge count."""
        m = self._edges(True)
        return self.csc_ptr, self.csc_ind[:m], self.csc_val[:m]

    def schedule(self, transpose: bool) -> RowSchedule:
        """The RowSchedule of the column block (transpose=True) or the row
        block, built at the first call and kept: every plan and min/max
        pull over the block reads this one."""
        key = "csc/schedule" if transpose else "csr/schedule"
        if key not in self._cache:
            self._cache[key] = build_schedule(
                self.csc_ptr if transpose else self.csr_ptr)
        return self._cache[key]

    @property
    def pull_plan(self) -> BitmapPlan:
        """The column block's K1 plan (BFS's structure-only pull), built at
        the first use over the block's schedule and kept."""
        if "pull_plan" not in self._cache:
            ptr, ind, _ = self.csc()
            self._cache["pull_plan"] = build_plan_bitmap(
                ptr, ind, self.rows_per, self.n_pad, self.schedule(True))
        return self._cache["pull_plan"]

    @property
    def value_pull_plan(self) -> ValuePlan:
        """The column block's value-pull plan over its stored values
        (PageRank's pull over the prepared matrix), built at the first use
        over the block's schedule and kept."""
        if "value_pull_plan" not in self._cache:
            ptr, ind, val = self.csc()
            self._cache["value_pull_plan"] = build_plan(
                ptr, ind, val, self.rows_per, self.n_pad, self.schedule(True))
        return self._cache["value_pull_plan"]

    def to_numpy(self) -> dict:
        """The six block arrays on the host, by leaf name."""
        return {k: getattr(self, k).cpu().numpy() for k in LEAVES}

    @staticmethod
    def from_jax_arrays(arrays: dict, rank: int, *, n: int, nvals: int,
                        device="cuda") -> "ShardedMatrix":
        """Rank `rank`'s ShardedMatrix from the JAX package's stacked (P,
        ...) leaves as NumPy arrays ({"csr_ptr": np.asarray(Ash.csr_ptr),
        ...}): row `rank` of each, on `device`. n and nvals are the JAX
        ShardedMatrix's."""
        P, rows_per1 = arrays["csr_ptr"].shape
        rows_per = rows_per1 - 1
        leaves = {k: torch.from_numpy(np.ascontiguousarray(
            arrays[k][rank])).to(device) for k in LEAVES}
        return ShardedMatrix(n=n, n_pad=P * rows_per, P=P, rows_per=rows_per,
                             nvals=nvals, rank=rank, **leaves)


def _block_csr(rows, cols, vals, lo: int, hi: int) -> tuple:
    """CSR of the entries with rows in [lo, hi): local row ids, global
    cols, each row sorted by column (mmio.coo_to_csr, native from 2^20
    entries on)."""
    sel = (rows >= lo) & (rows < hi)
    return mmio.coo_to_csr(rows[sel] - lo, cols[sel], vals[sel], hi - lo)


def _padded(block: tuple, cap: int, n_pad: int, np_dtype) -> tuple:
    ptr, ind, val = block
    inds = np.full(cap, n_pad, dtype=np.int32)
    vals = np.zeros(cap, dtype=np_dtype)
    inds[:len(ind)] = ind
    vals[:len(val)] = val
    return ptr.astype(np.int32), inds, vals


def partition(A: Matrix, mesh, axis: str = AXIS,
              pad_edges_to: int = 1024) -> ShardedMatrix:
    """This rank's blocks of the 1D partition of square A over `mesh` (a
    1D DeviceMesh, `bootstrap.global_mesh`), on the rank's device. Every
    rank reads A's entries on the host and builds its own two blocks; the
    plans and schedules are built at their first use."""
    if A.nrows != A.ncols:
        raise ValueError("the 1D partition takes a square adjacency matrix")
    P = mesh.size()
    rank = mesh.get_local_rank(axis)
    n = A.nrows
    rows_per = round_up(n, P * 8) // P
    n_pad = rows_per * P

    r, c, v = A.extract_tuples()
    # the capacity of every block's edge arrays, from the edge count of
    # each block, so that each rank pads as the JAX package pads them all
    counts = np.concatenate([np.bincount(r // rows_per, minlength=P),
                             np.bincount(c // rows_per, minlength=P)])
    cap = max(round_up(int(counts.max()) if len(r) else 0, pad_edges_to),
              pad_edges_to)
    lo, hi = rank * rows_per, (rank + 1) * rows_per
    np_dtype = _numpy_dtype(A.dtype)
    csr = _padded(_block_csr(r, c, v, lo, hi), cap, n_pad, np_dtype)
    # column block k = the rows of Aᵀ in [lo, hi)
    csc = _padded(_block_csr(c, r, v, lo, hi), cap, n_pad, np_dtype)
    dev = mesh_device(mesh)
    leaves = {k: torch.from_numpy(a).to(dev)
              for k, a in zip(LEAVES, csr + csc)}
    return ShardedMatrix(n=n, n_pad=n_pad, P=P, rows_per=rows_per,
                         nvals=A.nvals, rank=rank, **leaves)


def shard_vector(mesh, x: np.ndarray, n_pad: int, axis: str = AXIS,
                 fill=0) -> torch.Tensor:
    """This rank's block of host vector x padded to n_pad with `fill`, on
    the rank's device."""
    P = mesh.size()
    rank = mesh.get_local_rank(axis)
    rows_per = n_pad // P
    xp = np.full((n_pad,), fill, dtype=x.dtype)
    xp[:len(x)] = x
    return torch.from_numpy(
        xp[rank * rows_per:(rank + 1) * rows_per].copy()).to(
            mesh_device(mesh))


# ---------------------------------------------------------------------------
# The partition checkpoint cache (the reference caches only the single-GPU
# CSR .bin; here the costly artifact is each rank's padded block set)
# ---------------------------------------------------------------------------


def shard_cache_path(base: str, P: int, rank: int = 0) -> str:
    """The hidden sidecar of rank `rank`'s blocks of a P-way partition of
    the graph at `base` (an .mtx path or any identifying stem), beside
    the mtx sidecar's `.torch.npz`: one file a rank, so no two ranks
    write one file, and none is the JAX package's."""
    import os

    d, b = os.path.split(base)
    stem = os.path.splitext(b)[0]
    return os.path.join(d or ".", f".{stem}.p{P}.r{rank}.shards.torch.npz")


def _content_fingerprint(A: Matrix) -> int:
    """A cheap fingerprint of A's structure and values, so that a graph
    regenerated with the same (n, nvals) (an RMAT of another seed,
    reweighted edges) does not load stale blocks: a crc32 of the CSR
    arrays sampled at stride max(1, len // 65536); only the samples leave
    the device. It equals the JAX package's on the same graph."""
    import zlib

    parts = []
    for arr in (A.row_ptr, A.col_ind, A.val):
        if arr is None:
            continue
        stride = max(1, arr.shape[0] // 65536)
        parts.append(np.ascontiguousarray(
            arr[::stride].cpu().numpy()).tobytes())
    return zlib.crc32(b"".join(parts)) & 0x7FFFFFFF


def partition_cached(A: Matrix, mesh, cache_base: str,
                     axis: str = AXIS) -> ShardedMatrix:
    """partition() with an npz checkpoint of this rank's blocks, keyed on
    the graph (n, nvals and `_content_fingerprint`) and the number of
    ranks. The first run builds the blocks and saves them; a later run
    loads them and only copies them to the device. A directory that
    cannot be written skips the saving. The plans stay derived data,
    built at their first use."""
    import os

    P = mesh.size()
    rank = mesh.get_local_rank(axis)
    cpath = shard_cache_path(cache_base, P, rank)
    fp = _content_fingerprint(A)
    if os.path.exists(cpath):
        with np.load(cpath) as z:
            if (int(z["nvals"]) == A.nvals and int(z["n"]) == A.nrows
                    and int(z["fingerprint"]) == fp):
                dev = mesh_device(mesh)
                return ShardedMatrix(
                    n=int(z["n"]), n_pad=int(z["n_pad"]), P=P,
                    rows_per=int(z["rows_per"]), nvals=int(z["nvals"]),
                    rank=rank, **{k: torch.from_numpy(z[k]).to(dev)
                                  for k in LEAVES})
    Ash = partition(A, mesh, axis=axis)
    try:
        np.savez(cpath, n=Ash.n, n_pad=Ash.n_pad, rows_per=Ash.rows_per,
                 nvals=Ash.nvals, fingerprint=fp, **Ash.to_numpy())
    except OSError:
        pass    # a read-only directory: no cache (as the reference's .bin)
    return Ash
