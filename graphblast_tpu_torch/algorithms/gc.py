"""Graph colouring: IS, MIS and Jones-Plassmann variants (counterpart of
graphblast_tpu/algorithms/gc.py; reference:
graphblas/algorithm/gc.hpp:16-406).

  is   (gc.hpp:43-148):  one Luby independent set per colour; colour =
       round id. One launch of the min/max row fold S per round.
  mis  (gc.hpp:151-254): a full MIS per colour (fewer colours, more work).
  jp   (gc.hpp:257-406): Jones-Plassmann with the reference's global
       minimum unused colour (neighbour colours scattered into a dense
       max_colors array, gc.hpp:358-377). One S and two K6 launches per
       round (the or pull: x at the row ids, the row boundaries). With
       more colours than max_colors the minimum saturates at max_colors.
  cusparse: the reference's vendor csrcolor (gc.hpp:16-40), mapped to is.

Every pull is the plan-less `spmv_pull` over the int32 CSC, the max over
the CSC's cached row schedule; the weights come from `mis.random_weights`.
The loops are Python loops with one host read of `succ` per round.
"""
from __future__ import annotations

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.spmv import spmv_pull
from ..semiring import LogicalOrAndSemiring, MaximumMultipliesSemiring
from ..vector import Vector
from .common import csc_int_arrays, dense_result
from .mis import _mis_fused, random_weights


def _gc_is_round(A: Matrix, v, w, it: int, csc: tuple):
    ptr, ind, val, sched = csc
    # unmasked max of the neighbours' weights (gc.hpp:104-106)
    m = spmv_pull(ptr, ind, val, w, MaximumMultipliesSemiring, A.nrows,
                  sched=sched)
    f = (w > m).to(torch.int32)   # eWiseAdd GreaterPlus (gc.hpp:112-113)
    succ = f.sum()
    v = torch.where(f != 0, it, v)   # assign colour (gc.hpp:123)
    w = torch.where(f != 0, 0, w)    # drop the candidates
    return v, w, succ


def _gc_jp_round(A: Matrix, v, w, max_colors: int, csc: tuple):
    n = A.nrows
    ptr, ind, val, sched = csc
    # masked max of the neighbours' weights (gc.hpp:337-339)
    m = spmv_pull(ptr, ind, val, w, MaximumMultipliesSemiring, n,
                  mask_dense=w, sched=sched)
    f = (w > m).to(torch.int32)
    succ = f.sum()
    # coloured neighbours of the frontier (gc.hpp:354-356: mask = v)
    nbr = spmv_pull(ptr, ind, val, f, LogicalOrAndSemiring, n, mask_dense=v)
    ncol = nbr * v   # their colours (eWiseMult PlusMultiplies, gc.hpp:359)
    # global minimum unused colour: scatter the colours into a dense array,
    # the least unused slot id; colour 0 excluded (gc.hpp:363-377)
    d = torch.zeros(max_colors, dtype=torch.int32, device=v.device)
    d[ncol.clamp(0, max_colors - 1).long()] = max_colors
    ids = torch.arange(max_colors, dtype=torch.int32, device=v.device)
    min_array = (d + ids).clamp(max=max_colors)
    min_array[0] = max_colors
    min_color = min_array.min()
    v = torch.where(f != 0, min_color, v)
    w = torch.where(f != 0, 0, w)
    return v, w, succ


def _gc_loop(A: Matrix, w0: torch.Tensor, step, max_niter: int):
    """Rounds from v = 0: `it` starts at 1 and the loop runs while succ > 0
    and it <= max_niter. Returns (colours int32, rounds run)."""
    v = torch.zeros(A.nrows, dtype=torch.int32, device=A.device)
    w = w0
    it, succ = 1, 1
    while succ > 0 and it <= max_niter:
        v, w, succ_t = step(v, w, it)
        succ = int(succ_t)          # the one host sync of the round
        it += 1
    return v, it - 1


def _gc_is_fused(A: Matrix, w0: torch.Tensor, *, max_niter: int):
    """gcIS: returns (colours, rounds run)."""
    csc = csc_int_arrays(A)
    return _gc_loop(A, w0, lambda v, w, it: _gc_is_round(A, v, w, it, csc),
                    max_niter)


def _gc_jp_fused(A: Matrix, w0: torch.Tensor, *, max_colors: int,
                 max_niter: int):
    """gcJP: returns (colours, rounds run)."""
    csc = csc_int_arrays(A)
    return _gc_loop(
        A, w0, lambda v, w, it: _gc_jp_round(A, v, w, max_colors, csc),
        max_niter)


def _gc_mis(A: Matrix, w0: torch.Tensor, desc: Descriptor):
    """gcMIS (gc.hpp:151-254): peel a full MIS of the remaining candidates
    per colour, in a host loop. Returns (colours, colours used)."""
    csc = csc_int_arrays(A)
    v = torch.zeros(A.nrows, dtype=torch.int32, device=A.device)
    w = w0
    used = 0
    for color in range(1, desc.max_niter + 1):
        f, _ = _mis_fused(A, w, max_niter=desc.max_niter, csc=csc)
        if int(f.sum()) == 0:
            break
        v = torch.where(f != 0, color, v)
        w = torch.where(f != 0, 0, w)
        used = color
    return v, used


def gc(A: Matrix, seed: int = 0, max_colors: int = 128,
       desc: Descriptor = DEFAULT, algo: str = "is") -> Vector:
    """Vertex colours ≥ 1 (0 = uncoloured), int32. algo ∈ {is, mis, jp,
    cusparse}, as the --gcalgo flag of the reference example ggc.cu. Runs on
    A's device."""
    w0 = random_weights(A.nrows, seed if seed else desc.seed, A.device)
    if algo in ("is", "cusparse"):
        v, _ = _gc_is_fused(A, w0, max_niter=desc.max_niter)
    elif algo == "jp":
        v, _ = _gc_jp_fused(A, w0, max_colors=max_colors,
                            max_niter=desc.max_niter)
    elif algo == "mis":
        v, _ = _gc_mis(A, w0, desc)
    else:
        raise ValueError(f"unknown gc algo {algo!r}")
    return dense_result(A.nrows, v)


def gc_cpu(A: Matrix, seed: int = 0):
    """Golden CPU reference passthrough (reference: test_gc.hpp)."""
    from .reference import gc_cpu as _impl

    return _impl(A, seed)


def verify_gc(A: Matrix, colors) -> bool:
    from .reference import verify_gc as _impl

    return _impl(A, colors)
