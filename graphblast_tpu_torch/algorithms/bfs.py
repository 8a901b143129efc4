"""BFS (counterpart of graphblast_tpu/algorithms/bfs.py; reference:
graphblas/algorithm/bfs.hpp:14-89).

Per iteration, as in the reference:
    assign(v, mask=f1, iter)                        # label newly-found
    f2 = vxm(¬v-masked, LogicalOrAnd, f1, A)        # expand frontier
    succ = reduce(+, f2)                            # convergence scalar

Both modes are a Python loop over device work with one host read of `succ`
per iteration, and one more where `mxv_dual` chooses a direction and sizes
the push (PUSHPULL and PUSHONLY). The JAX package's fused mode runs the
loop on the device with no host sync; `mode="fused"` here keeps its
semantics (it starts at 1, the loop runs while succ > 0 and it <=
max_niter). desc.mxv_mode picks the direction: PUSHPULL (BFS_TUNED's)
switches between push and pull by the frontier's density. As in the JAX
package, the fused pull goes over the bitmap plan (K1) and the stepped pull
with no plan, through `spmv_pull` (K5 and K6); the push is the bitmap push P
(`mxv_dual`'s BITMAP route) for the structure-only BFS, and the workspace
push of `ops/spmspv.py`, gathering through K6, for a BFS over the
frontier's values. Both images of the frontier stay valid every
iteration. The stepped mode also prints and times each iteration.
"""
from __future__ import annotations

import torch

from ..descriptor import BFS_TUNED, Descriptor
from ..matrix import Matrix
from ..ops.dispatch import DualFrontier, mxv_dual
from ..ops.kernels.bitmap_pull import plan_for_bitmap
from ..semiring import LogicalOrAndSemiring
from ..types import INDEX_DTYPE, Direction
from ..utils.profiling import annotate
from ..vector import Vector
from .common import (TightTimer, dense_result, edge_cap_for, print_dirinfo,
                     print_iter_row)


def _initial_frontier(n: int, source: int, device, dtype=torch.float32,
                      with_values: bool = False) -> DualFrontier:
    """The source alone, the sparse image of capacity n; `with_values`
    gives it values (1 at the source), which a push that is not
    structure-only multiplies."""
    dense = torch.zeros(n, dtype=dtype, device=device)
    dense[source] = 1
    sind = torch.full((n,), n, dtype=INDEX_DTYPE, device=device)
    sind[0] = source
    sval = None
    if with_values:
        sval = torch.zeros(n, dtype=dtype, device=device)
        sval[0] = 1
    return DualFrontier(n, dense, sind, sval,
                        torch.tensor(1, dtype=INDEX_DTYPE, device=device),
                        torch.tensor(1.0 / n, device=device),
                        torch.tensor(True, device=device))


def _assign_levels(v: torch.Tensor, f: DualFrontier, it: int):
    """assign(v, mask=f, it) in place on v, an (n + 1,) buffer whose last
    slot is spare, from the frontier's dense image."""
    v[:v.shape[0] - 1].masked_fill_(f.dense != 0, float(it))


def _bfs_step(A: Matrix, v: torch.Tensor, f: DualFrontier, it: int, *,
              struconly, switchpoint, mode, edge_cap=None, sort_push=True,
              plan=None):
    """One BFS iteration: label + masked expand. `v` is the (n + 1,) level
    buffer, updated in place."""
    # assign(v, mask=f1, iter, GrB_ALL), bfs.hpp:64-65
    _assign_levels(v, f, it)
    # the scmp-masked vxm, bfs.hpp:67-70 (mask = visited v, complemented)
    f2, used_push = mxv_dual(
        A, f, LogicalOrAndSemiring, identity=0.0, transpose=True,
        mask_dense=v[:A.nrows], mask_scmp=True, structure_only=struconly,
        edge_cap=edge_cap, sort_push=sort_push, switchpoint=switchpoint,
        mode=mode, pull_plan=plan)
    succ = f2.snvals  # struconly reduce == nvals (reduce.hpp:71-75)
    return v, f2, succ, used_push


def bfs_pull_plan(A: Matrix, desc: Descriptor = BFS_TUNED):
    """Bitmap plan for BFS's vxm pull (CSC). Counting frontier neighbours
    is the or-pull only when traversal ignores edge weights, so None unless
    the descriptor is structure-only, and None when BFS pushes. Built on
    the CPU and CUDA alike."""
    if not desc.structure_only or desc.mxv_mode == Direction.PUSHONLY:
        return None
    return plan_for_bitmap(A, transpose=True)


def _bfs_levels(A: Matrix, source: int, desc: Descriptor, plan,
                stepped: bool) -> torch.Tensor:
    """The BFS loop from `source`: the (n,) float32 levels. The stepped
    mode prints each iteration's row and direction switches as desc asks.
    Under a profiler each iteration is a "gb.bfs.iter" span holding its
    host read of succ, "gb.bfs.read"."""
    kw = dict(struconly=desc.structure_only, switchpoint=desc.switchpoint,
              mode=desc.mxv_mode, edge_cap=edge_cap_for(A, desc),
              sort_push=desc.sort_push)
    n = A.nrows
    timer = TightTimer() if stepped else None
    v = torch.zeros(n + 1, dtype=torch.float32, device=A.device)
    f = _initial_frontier(n, source, A.device,
                          with_values=not desc.structure_only)
    unvisited = n
    prev_push = None
    it, succ = 1, 1
    while succ > 0 and it <= desc.max_niter:
        with annotate("gb.bfs.iter"):
            if stepped:
                timer.start()
            v, f, succ_t, used_push = _bfs_step(A, v, f, it, plan=plan, **kw)
            with annotate("gb.bfs.read"):
                succ = int(succ_t)          # the loop's host read
            if stepped:
                ms = timer.stop(v, f.dense)
                unvisited -= succ
                print_dirinfo(succ, n, used_push, prev_push, desc.dirinfo)
                prev_push = used_push
                print_iter_row(it, succ, n, unvisited, used_push, ms,
                               desc.timing)
        it += 1
    return v[:n]


def bfs(A: Matrix, source: int, desc: Descriptor = BFS_TUNED,
        mode: str = "fused") -> Vector:
    """BFS levels: source = 1, unreached = 0, float32 (reference:
    bfs.hpp:14-89; levels per SimpleReferenceBfs, test_bfs.hpp:19-22).
    Runs on A's device, in the direction desc.mxv_mode asks for. A
    descriptor that is not structure-only pulls with no plan in both modes,
    and pushes the frontier's values. Any mode but "fused" runs stepped,
    as in the JAX package."""
    stepped = mode != "fused"
    plan = None if stepped else bfs_pull_plan(A, desc)
    return dense_result(A.nrows, _bfs_levels(A, source, desc, plan, stepped))


def bfs_cpu(A: Matrix, source: int):
    """Golden CPU reference passthrough (reference: bfs.hpp:92-113)."""
    from .reference import bfs_cpu as _impl

    return _impl(A, source)
