"""The 2D block layout over an (R, C) mesh (counterpart of
graphblast_tpu/parallel/partition2d.py).

A 1D row partition sends each rank's exchange over the whole mesh; the
2D block partition (the SUMMA / CombBLAS layout) bounds it to one mesh
row and one mesh column:

  rank (i, j), global rank i·C + j, owns block A[i·rb:(i+1)·rb,
  j·cb:(j+1)·cb] as a CSR with block-LOCAL column ids;
  pull y = A ⊕.⊗ x:
      x       = all-gather over "c" (my mesh row), then over "r" (my mesh
                column)
      partial = the block's spmv_pull over column segment j of x
      y_i     = ⊕-combine of the partials over "c"
      return slice j of y_i.

The mesh is a 2D `DeviceMesh` with axes ("r", "c"), built by the caller:
`init_device_mesh(device_type, (R, C), mesh_dim_names=("r", "c"))`.
Vectors are sharded in the mesh's row-major order, so rank i·C + j holds
segment i·C + j of length n_pad / (R·C) of the same (n_pad,) vector the
1D layout shards. rank (i, j)'s arrays equal the JAX package's (R, C, ·)
leaves at [i, j].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..matrix import Matrix, _numpy_dtype
from ..ops.kernels.minmax_pull import minmax_supported
from ..ops.kernels.row_schedule import RowSchedule, build_schedule
from ..types import round_up
from . import ops as dops
from .bootstrap import mesh_device
from .ring import _bucket_counts, _split_blocks

AXES = ("r", "c")
LEAVES_2D = ("ptr", "ind", "val")


@dataclasses.dataclass(eq=False)
class Sharded2D:
    """Rank (i, j)'s block of a 2D-partitioned square matrix.

      ptr (rows_blk+1,) int32  local CSR row pointers of block (i, j)
      ind (cap,) int32         block-LOCAL column ids (pad: cols_blk)
      val (cap,)
    n is the true vertex count, nvals the whole matrix's edge count."""

    n: int
    n_pad: int
    R: int
    C: int
    rows_blk: int
    cols_blk: int
    nvals: int
    i: int
    j: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: torch.Tensor
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.ptr.device

    @property
    def seg(self) -> int:
        """The length of each rank's vector segment, n_pad / (R·C)."""
        return self.n_pad // (self.R * self.C)

    @property
    def flat_rank(self) -> int:
        return self.i * self.C + self.j

    def block(self) -> tuple:
        """(ptr, ind, val), ind and val cut at the block's edge count."""
        if "edges" not in self._cache:
            self._cache["edges"] = int(self.ptr[-1])
        m = self._cache["edges"]
        return self.ptr, self.ind[:m], self.val[:m]

    def schedule(self) -> RowSchedule:
        """The block's RowSchedule, built at the first call and kept."""
        if "schedule" not in self._cache:
            self._cache["schedule"] = build_schedule(self.ptr)
        return self._cache["schedule"]

    def to_numpy(self) -> dict:
        return {k: getattr(self, k).cpu().numpy() for k in LEAVES_2D}


def partition_2d(A: Matrix, mesh, axes=AXES,
                 pad_edges_to: int = 1024) -> Sharded2D:
    """This rank's block of the 2D partition of square A over the (R, C)
    `mesh`, on the rank's device. Every rank counts the edges of all R·C
    blocks for the common capacity and builds its own block."""
    if A.nrows != A.ncols:
        raise ValueError("the 2D partition takes a square adjacency matrix")
    R, C = mesh.size(0), mesh.size(1)
    i, j = mesh.get_local_rank(axes[0]), mesh.get_local_rank(axes[1])
    n = A.nrows
    rows_blk = round_up(n, R * C * 8) // R
    cols_blk = round_up(n, R * C * 8) // C
    r, c, v = A.extract_tuples()
    counts = _bucket_counts(r, c, rows_blk, cols_blk, R, C)
    cap = max(round_up(max(int(counts.max()), 1), pad_edges_to),
              pad_edges_to)
    # rank (i, j)'s entries, their column ids local to column block j
    lo = i * rows_blk
    sel = (r >= lo) & (r < lo + rows_blk) & (c // cols_blk == j)
    ptrs, inds, vals = _split_blocks(r[sel], c[sel] - j * cols_blk, v[sel],
                                     lo, rows_blk, cols_blk, 1, cap,
                                     _numpy_dtype(A.dtype))
    dev = mesh_device(mesh)
    return Sharded2D(n=n, n_pad=rows_blk * R, R=R, C=C, rows_blk=rows_blk,
                     cols_blk=cols_blk, nvals=A.nvals, i=i, j=j,
                     ptr=torch.from_numpy(ptrs[0]).to(dev),
                     ind=torch.from_numpy(inds[0]).to(dev),
                     val=torch.from_numpy(vals[0]).to(dev))


def gather_2d(block: torch.Tensor, mesh, axes=AXES) -> torch.Tensor:
    """The segments of every rank in the mesh's row-major order: an
    all-gather over "c" (my mesh row), then over "r" (my mesh column)."""
    row = dops.all_gather(block, mesh.get_group(axes[1]))
    return dops.all_gather(row, mesh.get_group(axes[0]))


def all_reduce_2d(t: torch.Tensor, op, mesh, axes=AXES) -> torch.Tensor:
    """t reduced over every rank of the mesh: over "c", then "r"."""
    dops.all_reduce(t, op, mesh.get_group(axes[1]))
    return dops.all_reduce(t, op, mesh.get_group(axes[0]))


def _pull_block(Ash: Sharded2D, x_seg: torch.Tensor, semiring, mesh,
                structure_only: bool = False, axes=AXES) -> torch.Tensor:
    """This rank's segment of y = A ⊕.⊗ x from its segment of x, in the
    four steps of the module docstring. Every rank of the mesh calls it."""
    rb, cb = Ash.rows_blk, Ash.cols_blk
    x_full = gather_2d(x_seg, mesh, axes)
    x_col = x_full[Ash.j * cb:(Ash.j + 1) * cb]
    sched = Ash.schedule() if minmax_supported(semiring, x_seg.dtype) \
        else None
    part = dops._local_pull(*Ash.block(), x_col, semiring, rb, None, False,
                            structure_only, sched)
    # ⊕-combine the partials of the C ranks of my mesh row
    group = mesh.get_group(axes[1])
    op = dops._REDUCE_OPS.get(semiring.add.name)
    if semiring.add.name == "LogicalOrMonoid":
        op = dist.ReduceOp.MAX
    if op is not None:
        y = dops.all_reduce(part.contiguous(), op, group)
    else:
        parts = dops.all_gather(part.reshape(1, -1), group)      # (C, rb)
        y = torch.full_like(part, semiring.identity(part.dtype).item())
        for k in range(parts.shape[0]):
            y = semiring.add(y, parts[k]).to(part.dtype)
    seg = rb // Ash.C
    return y[Ash.j * seg:(Ash.j + 1) * seg]


def mxv_2d(Ash: Sharded2D, mesh, x: np.ndarray, semiring, axes=AXES,
           structure_only: bool = False) -> np.ndarray:
    """y = A ⊕.⊗ x over the 2D mesh (host entry: x is (n,) on the host),
    the whole (n,) result on every rank."""
    xp = np.zeros((Ash.n_pad,), np.dtype(x.dtype))
    xp[:len(x)] = x
    lo = Ash.flat_rank * Ash.seg
    xb = torch.from_numpy(xp[lo:lo + Ash.seg].copy()).to(Ash.device)
    y = _pull_block(Ash, xb, semiring, mesh, structure_only, axes)
    return gather_2d(y, mesh, axes)[:Ash.n].cpu().numpy()
