"""The ring-staged pull (counterpart of graphblast_tpu/parallel/ring.py).

The all-gather pull (ops.dist_mxv_pull) assembles the whole (n_pad,)
vector on every rank before any work starts. The ring keeps one 1/P
segment of x in flight instead:

    stage k (of P):  send x_seg to rank (my+1) mod P, receive the next
                     from rank (my-1) mod P              (posted first)
                     partial ⊕= A_block[:, seg(my−k)] ⊗ x_seg  (local)
                     wait for the exchange

The send and receive are posted with `dist.batch_isend_irecv` before the
stage's local pull and waited for after it, so the transfer of one
segment overlaps the multiply by the one in hand, and peak vector memory
is O(n/P). The last stage exchanges nothing, and at P = 1 there is no
exchange at all.

Storage: rank k holds its CSR row block split by column segment, P CSR
blocks with segment-LOCAL column ids, padded to one capacity (the most
edges of any (row block, segment) pair over the whole matrix, rounded up
to `pad_edges_to`) with the rows_per sentinel, so rank k's arrays equal
row k of the JAX package's (P, P, ·) leaves. Each stage pulls through
`ops/spmv.py spmv_pull`, as the JAX ring does: the Plus pulls gather x on
K6, the min/max pulls fold on S over the block's row schedule (built at
its first use and kept), the structure-only or-pull runs K5 and K6.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..io import mmio
from ..matrix import Matrix, _numpy_dtype
from ..ops.kernels.minmax_pull import minmax_supported
from ..ops.kernels.row_schedule import RowSchedule, build_schedule
from ..types import round_up
from . import ops as dops
from .bootstrap import AXIS, mesh_device

RING_LEAVES = ("ptr", "ind", "val")


@dataclasses.dataclass(eq=False)
class RingShardedMatrix:
    """Rank `rank`'s row block, split by column segment for ring stages.

      ptr (P, rows_per+1) int32  CSR pointers of (row block, segment j)
      ind (P, cap) int32         segment-LOCAL column ids (pad: rows_per)
      val (P, cap)
    n is the true vertex count, nvals the whole matrix's edge count."""

    n: int
    n_pad: int
    P: int
    rows_per: int
    nvals: int
    rank: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: torch.Tensor
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.ptr.device

    def block(self, j: int) -> tuple:
        """(ptr, ind, val) of segment j's block, cut at its edge count."""
        if "edges" not in self._cache:
            self._cache["edges"] = self.ptr[:, -1].tolist()
        m = self._cache["edges"][j]
        return self.ptr[j], self.ind[j, :m], self.val[j, :m]

    def schedule(self, j: int) -> RowSchedule:
        """Segment j's block's RowSchedule, built at the first call and
        kept (the min/max pulls on S read it)."""
        key = ("schedule", j)
        if key not in self._cache:
            self._cache[key] = build_schedule(self.ptr[j])
        return self._cache[key]

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).cpu().numpy() for k in RING_LEAVES}


def _bucket_counts(r, c, rows_blk: int, cols_blk: int, R: int,
                   C: int) -> np.ndarray:
    """The edge count of every (row block, column block) pair, (R·C,)."""
    return np.bincount((r // rows_blk) * C + c // cols_blk,
                       minlength=R * C)


def _split_blocks(r, c, v, lo: int, rows: int, cols_blk: int, nblocks: int,
                  cap: int, np_dtype) -> tuple:
    """The CSR blocks of rows [lo, lo+rows), one for each of the nblocks
    column blocks of cols_blk columns, with block-local ids, padded to
    cap with the cols_blk sentinel: (ptrs, inds, vals), stacked."""
    sel = (r >= lo) & (r < lo + rows)
    r, c, v = r[sel] - lo, c[sel], v[sel]
    ptrs = np.zeros((nblocks, rows + 1), np.int32)
    inds = np.full((nblocks, cap), cols_blk, np.int32)
    vals = np.zeros((nblocks, cap), np_dtype)
    jb = c // cols_blk
    for j in range(nblocks):
        s = jb == j
        ptr, ci, vv = mmio.coo_to_csr(r[s], c[s] - j * cols_blk, v[s], rows)
        ptrs[j] = ptr
        inds[j, :len(ci)] = ci
        vals[j, :len(vv)] = vv
    return ptrs, inds, vals


def partition_ring(A: Matrix, mesh, axis: str = AXIS,
                   pad_edges_to: int = 256) -> RingShardedMatrix:
    """This rank's ring layout of square A over the 1D `mesh`, on the
    rank's device. Every rank reads A's entries on the host, counts the
    edges of all P·P blocks for the common capacity, and builds its own
    P blocks."""
    if A.nrows != A.ncols:
        raise ValueError("the ring partition takes a square adjacency "
                         "matrix")
    P = mesh.size()
    rank = mesh.get_local_rank(axis)
    n = A.nrows
    rows_per = round_up(n, P * 8) // P
    r, c, v = A.extract_tuples()
    counts = _bucket_counts(r, c, rows_per, rows_per, P, P)
    cap = max(round_up(max(int(counts.max()), 1), pad_edges_to),
              pad_edges_to)
    arrays = _split_blocks(r, c, v, rank * rows_per, rows_per, rows_per, P,
                           cap, _numpy_dtype(A.dtype))
    dev = mesh_device(mesh)
    ptr, ind, val = (torch.from_numpy(a).to(dev) for a in arrays)
    return RingShardedMatrix(n=n, n_pad=rows_per * P, P=P,
                             rows_per=rows_per, nvals=A.nvals, rank=rank,
                             ptr=ptr, ind=ind, val=val)


def _peer(group, k: int) -> int:
    """The global rank of the group's rank k."""
    return k if group is None else dist.get_global_rank(group, k)


def ring_mxv_pull(Rsh: RingShardedMatrix, x_block: torch.Tensor, semiring,
                  structure_only: bool = False, group=None) -> torch.Tensor:
    """y_block = (A ⊗ x)|my rows in P ring stages; x_block is this rank's
    (rows_per,) block. Every rank of the group calls it."""
    P, rows_per, my = Rsh.P, Rsh.rows_per, Rsh.rank
    # S, the min/max fold, reads the block's row schedule on the card
    sched = minmax_supported(semiring, x_block.dtype)
    acc = torch.full((rows_per,), semiring.identity(x_block.dtype).item(),
                     dtype=x_block.dtype, device=x_block.device)
    xseg = x_block.contiguous()
    for k in range(P):
        reqs = None
        if k < P - 1:
            nxt = torch.empty_like(xseg)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, xseg, _peer(group, (my + 1) % P),
                           group),
                dist.P2POp(dist.irecv, nxt, _peer(group, (my - 1) % P),
                           group)])
        owner = (my - k) % P
        part = dops._local_pull(*Rsh.block(owner), xseg, semiring, rows_per,
                                None, False, structure_only,
                                Rsh.schedule(owner) if sched else None)
        acc = semiring.add(acc, part).to(x_block.dtype)
        if reqs is not None:
            for req in reqs:
                req.wait()
            xseg = nxt
    return acc


def mxv_ring(A: Optional[Matrix], mesh, x: np.ndarray, semiring,
             Rsh: Optional[RingShardedMatrix] = None, axis: str = AXIS,
             structure_only: bool = False) -> np.ndarray:
    """Host entry: y = A ⊕.⊗ x with the ring-staged pull, the whole (n,)
    result on every rank. Partitions A unless Rsh is given."""
    if Rsh is None:
        Rsh = partition_ring(A, mesh, axis=axis)
    group = mesh.get_group(axis)
    xp = np.zeros((Rsh.n_pad,), np.dtype(x.dtype))
    xp[:len(x)] = x
    lo = Rsh.rank * Rsh.rows_per
    xb = torch.from_numpy(xp[lo:lo + Rsh.rows_per].copy()).to(Rsh.device)
    y = ring_mxv_pull(Rsh, xb, semiring, structure_only, group)
    return dops.all_gather(y, group)[:Rsh.n].cpu().numpy()
