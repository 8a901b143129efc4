"""SSSP, Bellman-Ford with frontier filtering (counterpart of
graphblast_tpu/algorithms/sssp.py; reference:
graphblas/algorithm/sssp.hpp:15-103).

Per iteration, as in the reference:
    f2 = vxm(MinimumPlus, f1, A)                 # relax candidates
    f2 = FLT_MAX where not (f2 < v)              # filter unproductive
    v  = min(v, f2)                              # relax
    succ = nvals(f2)                             # productive count

The filter is `mxv_dual`'s postprocess, as in the JAX package, so the
productive count is the filtered frontier's nvals: the loop hands
`mxv_dual` the distances as its `bound`, which writes FLT_MAX at every
candidate that does not lower them, on either route. desc.mxv_mode
picks the direction: PUSHPULL, the default, switches by the frontier's
density. The vxm pull runs the monoid pull (K4) over A's CSC plan
(`plan_for_monoid`), on the CPU and CUDA alike, through its masked entry,
which the bound lets skip the rows no candidate can lower (v <= min f +
the least weight) and read x and the weight only at the frontier's
columns; the push runs over A's CSR
as scatter pushes over slices of the frontier (`mxv_dual`'s SLICES route,
`ops/spmspv.py` `spmspv_push_exact`), gathering through K6. Both images of
the frontier stay valid every relaxation. Both modes are a Python loop
over device work with one host read per iteration: `succ`, read with what
the next `mxv_dual` needs to choose a direction and size the push (the
first iteration's dispatch reads apart; the JAX fused mode is one device
loop); "stepped" also prints the reference's per-iteration row when
desc.timing is set.
"""
from __future__ import annotations

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.dispatch import DualFrontier, frontier_state, mxv_dual
from ..ops.kernels.monoid_pull import FLT_MAX as MAXF
from ..ops.kernels.monoid_pull import MonoidPlan, plan_for_monoid
from ..semiring import MinimumPlusSemiring
from ..types import INDEX_DTYPE, Direction
from ..utils.profiling import annotate
from ..vector import Vector
from .common import (TightTimer, dense_result, edge_cap_for, print_dirinfo,
                     print_iter_row)


def _initial_frontier(n: int, source: int, device) -> DualFrontier:
    """The source alone, at distance 0: the dense image FLT_MAX elsewhere,
    the sparse image (capacity n) with values, FLT_MAX in the pads."""
    dense = torch.full((n,), MAXF, dtype=torch.float32, device=device)
    dense[source] = 0.0
    sind = torch.full((n,), n, dtype=INDEX_DTYPE, device=device)
    sind[0] = source
    sval = torch.full((n,), MAXF, dtype=torch.float32, device=device)
    sval[0] = 0.0
    return DualFrontier(n, dense, sind, sval,
                        torch.tensor(1, dtype=INDEX_DTYPE, device=device),
                        torch.tensor(1.0 / n, device=device),
                        torch.tensor(True, device=device))


def _sssp_step(A: Matrix, v: torch.Tensor, f: DualFrontier,
               plan: MonoidPlan, *, switchpoint, mode, edge_cap=None,
               sort_push=True, state=None):
    """One relaxation; `v` is the (n + 1,) distance buffer, updated in
    place; `state`, f's `frontier_state` where the caller read it."""
    vn = v[:A.nrows]
    # the bound is eWiseAdd(m, CustomLessPlus, f2, v) + the scmp-masked
    # assign of FLT_MAX (sssp.hpp:76-88) in one where
    f2, used_push = mxv_dual(
        A, f, MinimumPlusSemiring, identity=MAXF, transpose=True,
        edge_cap=edge_cap, sort_push=sort_push, switchpoint=switchpoint,
        mode=mode, pull_plan=plan, bound=vn, state=state)
    # v = min(v, f2), eWiseAdd MinimumPlus (sssp.hpp:80-82): filtered
    # entries are FLT_MAX and cannot lower v
    torch.minimum(vn, f2.dense, out=vn)
    return v, f2, f2.snvals, used_push


def _sssp_fused(A: Matrix, source: int, plan: MonoidPlan, *, switchpoint,
                mode, max_niter: int, timing: int = 0,
                dirinfo: bool = False, edge_cap=None, sort_push=True):
    """The relaxation loop from `source`: `it` starts at 1 and the loop runs
    while succ > 0 and it <= max_niter. Returns (v, iterations run). Under
    a profiler each relaxation is a "gb.sssp.iter" span holding its host
    read of succ, "gb.sssp.read". A loop that may push reads succ with
    the next dispatch's state of the new frontier (`frontier_state`), one
    host read a relaxation but for the first."""
    n = A.nrows
    f = _initial_frontier(n, source, A.device)
    # v0: FLT_MAX, 0 at the source, and the spare slot
    v = torch.cat([f.dense, f.dense.new_full((1,), MAXF)])
    printing = bool(timing or dirinfo)
    timer = TightTimer() if printing else None
    prev_push = None
    merged = mode != Direction.PULLONLY and A.pull_csr(False)[2] is not None
    it, succ, state = 1, 1, None
    while succ > 0 and it <= max_niter:
        with annotate("gb.sssp.iter"):
            if printing:
                timer.start()
            v, f, succ_t, used_push = _sssp_step(
                A, v, f, plan, switchpoint=switchpoint, mode=mode,
                edge_cap=edge_cap, sort_push=sort_push, state=state)
            with annotate("gb.sssp.read"):       # the loop's host read
                if merged:
                    state = frontier_state(A, f, MAXF, transpose=True)
                    succ = state[1]
                else:
                    succ = int(succ_t)
            if printing:
                ms = timer.stop(v, f.dense)
                print_dirinfo(succ, n, used_push, prev_push, dirinfo)
                prev_push = used_push
                # unvisited: still at the FLT_MAX sentinel (the reference's
                # CSV column, bfs.hpp:54-60)
                unvisited = int((v[:n] >= MAXF).sum()) if timing else n
                print_iter_row(it, succ, n, unvisited, used_push, ms, timing)
        it += 1
    return v[:n], it - 1


def sssp(A: Matrix, source: int, desc: Descriptor = DEFAULT,
         mode: str = "fused") -> Vector:
    """Distances from `source`, float32; unreachable = FLT_MAX (reference:
    sssp.hpp:26, the SimpleReferenceSssp conventions). Runs on A's device,
    in the direction desc.mxv_mode asks for. Any mode but "fused" runs
    stepped, as in the JAX package."""
    stepped = mode != "fused"
    plan = (None if desc.mxv_mode == Direction.PUSHONLY
            else plan_for_monoid(A, transpose=True))
    v, _ = _sssp_fused(A, source, plan, switchpoint=desc.switchpoint,
                       mode=desc.mxv_mode, max_niter=desc.max_niter,
                       timing=desc.timing if stepped else 0,
                       dirinfo=desc.dirinfo and stepped,
                       edge_cap=edge_cap_for(A, desc),
                       sort_push=desc.sort_push)
    return dense_result(A.nrows, v)


def sssp_cpu(A: Matrix, source: int):
    """Golden CPU reference passthrough (reference: test_sssp.hpp)."""
    from .reference import sssp_cpu as _impl

    return _impl(A, source)
