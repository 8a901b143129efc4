"""Maximal independent set, Luby's algorithm with random weights
(counterpart of graphblast_tpu/algorithms/mis.py; reference:
graphblas/algorithm/mis.hpp:23-160).

Per round, on dense int32 vectors:
    m = vxm(mask=w, MaximumMultiplies, w, A)    # max candidate-neighbour weight
    f = w > m                                   # local maxima (GreaterPlus)
    v ← 1 where f ; w ← 0 where f               # admit to set, drop candidates
    m2 = vxm(mask=w, LogicalOrAnd, f, A)        # neighbours of new members
    w ← 0 where m2                              # remove from candidates

Both pulls run the plan-less `spmv_pull` over the int32 CSC: on the card,
one launch of the min/max row fold S per round for the max (over the
CSC's cached row schedule), and two of the gather kernel K6 for the or (x
at the row ids, then the row boundaries). Both modes are a Python loop
with one host read of `succ` per round.

The weights come from a torch.Generator, not jax.random: the same seed gives
other weights than the JAX package's, and the same weights on the CPU and
the card. `f = w > m` is strict, so two adjacent candidates of equal weight
never enter the set, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.spmv import spmv_pull
from ..semiring import LogicalOrAndSemiring, MaximumMultipliesSemiring
from ..vector import Vector
from .common import TightTimer, csc_int_arrays, dense_result, print_iter_row


def random_weights(n: int, seed: int, device) -> torch.Tensor:
    """set_random equivalent (reference: common.hpp:8-23): int32 in
    [1, 2^30), strictly positive so weight 0 never blocks selection, drawn
    on the CPU from a generator seeded with `seed`, then moved to
    `device`."""
    g = torch.Generator()
    g.manual_seed(seed)
    w = torch.randint(1, 1 << 30, (n,), generator=g, dtype=torch.int32)
    return w.to(device)


def _mis_round(A: Matrix, v, w, csc: tuple):
    n = A.nrows
    ptr, ind, val, sched = csc
    # vxm(m, mask=w, MaximumMultiplies, w, A) — mis.hpp:81-83. CSC pull.
    m = spmv_pull(ptr, ind, val, w, MaximumMultipliesSemiring, n,
                  mask_dense=w, sched=sched)
    # f = w > m (eWiseAdd GreaterPlus, mis.hpp:88-89)
    f = (w > m).to(torch.int32)
    # assign v←1, w←0 under mask f (mis.hpp:92-98)
    v = torch.where(f != 0, 1, v)
    w = torch.where(f != 0, 0, w)
    succ = f.sum()
    # neighbour removal (mis.hpp:105-109)
    m2 = spmv_pull(ptr, ind, val, f, LogicalOrAndSemiring, n, mask_dense=w)
    w = torch.where(m2 != 0, 0, w)
    return v, w, succ


def _mis_fused(A: Matrix, w0: torch.Tensor, *, max_niter: int,
               timing: int = 0, csc: tuple = None):
    """The MIS of the candidates w0 (> 0): `it` starts at 1 and the loop
    runs while succ > 0 and it <= max_niter. `csc` is csc_int_arrays(A),
    made here when not given. Returns (membership 0/1 int32, rounds run)."""
    n = A.nrows
    csc = csc_int_arrays(A) if csc is None else csc
    v = torch.zeros(n, dtype=torch.int32, device=A.device)
    w = w0
    timer = TightTimer() if timing else None
    it, succ = 1, 1
    while succ > 0 and it <= max_niter:
        if timing:
            timer.start()
        v, w, succ_t = _mis_round(A, v, w, csc)
        succ = int(succ_t)          # the one host sync of the round
        if timing:
            print_iter_row(it, succ, n, n, False, timer.stop(v), timing)
        it += 1
    return v, it - 1


def mis_inner(A: Matrix, w0: torch.Tensor, max_niter: int = 10000):
    """misInner (reference: mis.hpp:23-141): the MIS of the candidate set
    w0, as a 0/1 int32 membership array."""
    v, _ = _mis_fused(A, w0, max_niter=max_niter)
    return v


def mis(A: Matrix, seed: int = 0, desc: Descriptor = DEFAULT,
        mode: str = "fused") -> Vector:
    """MIS membership vector, int32: 1 = in the set (reference:
    mis.hpp:113-148). Runs on A's device; the stepped mode prints a row per
    round."""
    if mode not in ("fused", "stepped"):
        raise ValueError(f"mode must be 'fused' or 'stepped', not {mode!r}")
    w0 = random_weights(A.nrows, seed if seed else desc.seed, A.device)
    v, _ = _mis_fused(A, w0, max_niter=desc.max_niter,
                      timing=desc.timing if mode == "stepped" else 0)
    return dense_result(A.nrows, v)


def mis_cpu(A: Matrix, seed: int = 0):
    """Golden CPU reference passthrough (reference: test_mis.hpp)."""
    from .reference import mis_cpu as _impl

    return _impl(A, seed)


def verify_mis(A: Matrix, in_set) -> bool:
    from .reference import verify_mis as _impl

    return _impl(A, in_set)
