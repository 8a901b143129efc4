"""SSSP, Bellman-Ford with frontier filtering (counterpart of
graphblast_tpu/algorithms/sssp.py; reference:
graphblas/algorithm/sssp.hpp:15-103).

Per iteration, as in the reference:
    f2 = vxm(MinimumPlus, f1, A)                 # relax candidates
    f2 = FLT_MAX where not (f2 < v)              # filter unproductive
    v  = min(v, f2)                              # relax
    succ = nvals(f2)                             # productive count

The filter is `mxv_dual`'s postprocess, as in the JAX package, so the
productive count is the filtered frontier's nvals; the push takes its
sparse twin, which filters each destination's candidate. desc.mxv_mode
PULLONLY and PUSHONLY are ported; PUSHPULL, the default, is ROADMAP queue 1
item 5b and raises. The vxm pull runs the monoid pull (K4) over A's CSC
plan (`plan_for_monoid`), on the CPU and CUDA alike; the push
(`ops/spmspv.py`) runs over A's CSR and gathers through K6. Both modes are
a Python loop over device work with one host read of `succ` per iteration
(and one more in a push iteration, which picks its workspace; the JAX
fused mode is one device loop); "stepped" also prints the reference's
per-iteration row when desc.timing is set.
"""
from __future__ import annotations

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.dispatch import DualFrontier, mxv_dual
from ..ops.gather_dispatch import take
from ..ops.kernels.monoid_pull import FLT_MAX as MAXF
from ..ops.kernels.monoid_pull import MonoidPlan, plan_for_monoid
from ..semiring import MinimumPlusSemiring
from ..types import INDEX_DTYPE, Direction
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
               sort_push=True, tiers=(64, 8)):
    def filter_unproductive(y):
        # eWiseAdd(m, CustomLessPlus, f2, v) + the scmp-masked assign of
        # FLT_MAX (sssp.hpp:76-88) in one where
        return torch.where(y < v, y, MAXF)

    def filter_sparse(keys, vals):
        # the push's twin: v at the sorted candidate keys (one ascending
        # gather), non-improving candidates to the FLT_MAX identity
        return torch.where(vals < take(v, keys, sorted=True), vals, MAXF)

    f2, used_push = mxv_dual(
        A, f, MinimumPlusSemiring, identity=MAXF, transpose=True,
        edge_cap=edge_cap, sort_push=sort_push, switchpoint=switchpoint,
        mode=mode, tier_divisors=tiers, pull_plan=plan,
        postprocess=filter_unproductive, postprocess_sparse=filter_sparse)
    # relax: v = min(v, f2) (eWiseAdd MinimumPlus, sssp.hpp:80-82);
    # filtered entries are FLT_MAX and cannot lower v
    v = torch.minimum(v, f2.dense)
    return v, f2, f2.snvals, used_push


def _sssp_fused(A: Matrix, source: int, plan: MonoidPlan, *, switchpoint,
                mode, max_niter: int, timing: int = 0,
                dirinfo: bool = False, edge_cap=None, sort_push=True,
                tiers=(64, 8)):
    """The relaxation loop from `source`: `it` starts at 1 and the loop runs
    while succ > 0 and it <= max_niter. Returns (v, iterations run)."""
    n = A.nrows
    f = _initial_frontier(n, source, A.device)
    v = f.dense                 # v0: FLT_MAX, 0 at the source
    timer = TightTimer()
    prev_push = None
    it, succ = 1, 1
    while succ > 0 and it <= max_niter:
        timer.start()
        v, f, succ_t, used_push = _sssp_step(
            A, v, f, plan, switchpoint=switchpoint, mode=mode,
            edge_cap=edge_cap, sort_push=sort_push, tiers=tiers)
        succ = int(succ_t)          # the loop's host read
        if timing or dirinfo:
            ms = timer.stop(v, f.dense)
            print_dirinfo(succ, n, used_push, prev_push, dirinfo)
            prev_push = used_push
            # unvisited: still at the FLT_MAX sentinel (the reference's CSV
            # column, bfs.hpp:54-60)
            unvisited = int((v >= MAXF).sum()) if timing else n
            print_iter_row(it, succ, n, unvisited, used_push, ms, timing)
        it += 1
    return v, it - 1


def sssp(A: Matrix, source: int, desc: Descriptor = DEFAULT,
         mode: str = "fused") -> Vector:
    """Distances from `source`, float32; unreachable = FLT_MAX (reference:
    sssp.hpp:26, the SimpleReferenceSssp conventions). Runs on A's device.
    desc.mxv_mode PULLONLY and PUSHONLY are ported: the default
    descriptor's PUSHPULL raises NotImplementedError, as BFS does."""
    if mode not in ("fused", "stepped"):
        raise ValueError(f"mode must be 'fused' or 'stepped', not {mode!r}")
    stepped = mode == "stepped"
    plan = (None if desc.mxv_mode == Direction.PUSHONLY
            else plan_for_monoid(A, transpose=True))
    v, _ = _sssp_fused(A, source, plan, switchpoint=desc.switchpoint,
                       mode=desc.mxv_mode, max_niter=desc.max_niter,
                       timing=desc.timing if stepped else 0,
                       dirinfo=desc.dirinfo and stepped,
                       edge_cap=edge_cap_for(A, desc),
                       sort_push=desc.sort_push, tiers=desc.push_tiers)
    return dense_result(A.nrows, v)


def sssp_cpu(A: Matrix, source: int):
    """Golden CPU reference passthrough (reference: test_sssp.hpp)."""
    from .reference import sssp_cpu as _impl

    return _impl(A, source)
