"""Local graph clustering, the Andersen-Chung-Lang PPR push (counterpart of
graphblast_tpu/algorithms/lgc.py; reference: graphblas/algorithm/
lgc.hpp:14-163).

An iteration, over the frontier f = {v : r(v) ≥ d(v)·eps, d(v) > 0}:
    p += α · r.*f                          (masked eWiseMult + eWiseAdd)
    r_f = (1-α)/2 · r.*f                   (masked eWiseMult)
    r = r off the frontier + r_f + A·(r_f / d)   (PlusDivides + accum mxv)
from r = e_source, while the previous iteration's frontier was not empty
and at most max_niter iterations have run, as the JAX package's loop runs.

The degrees d are A's row sums (`reduce_matrix_rows`, one gather of the
row boundaries on K6), and A·(r_f / d) is `spmv_pull` over PlusMultiplies:
on the card its gather of x at the column ids and its gather of the prefix
sums at the row boundaries each launch K6 once an iteration. The loop reads
the frontier's count on the host once an iteration, where the JAX
package's fused loop reads nothing (ROADMAP "Differences: Loops").

The semantics are the CPU golden's, which keeps the residual off the
frontier (test_lgc.hpp:14-80); the reference's GPU loop zeroes it.
"""
from __future__ import annotations

import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.elementwise import reduce_matrix_rows
from ..ops.spmv import spmv_pull
from ..semiring import PlusMonoid, PlusMultipliesSemiring
from ..vector import Vector
from .common import dense_result


def _lgc_step(A: Matrix, p: torch.Tensor, r: torch.Tensor,
              deg: torch.Tensor, alpha: float, eps: float):
    # the frontier (lgc.hpp:131-133); deg > 0 keeps isolated vertices out
    f = (r >= deg * eps) & (deg > 0)
    succ = f.sum()
    p = p + torch.where(f, alpha * r, 0.0)                 # lgc.hpp:105-110
    spread = torch.where(f, (1.0 - alpha) / 2.0 * r, 0.0)  # lgc.hpp:113-114
    r2 = torch.where(f, spread / deg.clamp(min=1.0), 0.0)  # lgc.hpp:118-122
    push = spmv_pull(A.row_ptr, A.col_ind, A.val, r2,
                     PlusMultipliesSemiring, A.nrows)      # lgc.hpp:125-126
    return p, torch.where(f, spread, r) + push, succ


def _lgc_loop(A: Matrix, source: int, *, alpha: float, eps: float,
              max_niter: int):
    """(p, r, iterations run)."""
    n = A.nrows
    deg = reduce_matrix_rows(A.row_ptr, A.val, PlusMonoid, n)
    p = torch.zeros(n, dtype=torch.float32, device=A.device)
    r = torch.zeros(n, dtype=torch.float32, device=A.device)
    r[source] = 1.0
    it, succ = 1, 1
    while succ > 0 and it <= max_niter:
        p, r, succ_t = _lgc_step(A, p, r, deg, alpha, eps)
        succ = int(succ_t)         # the one host read of the iteration
        it += 1
    return p, r, it - 1


def lgc(A: Matrix, source: int, alpha: float = 0.15, eps: float = 1e-6,
        desc: Descriptor = DEFAULT) -> Vector:
    """The approximate personalized-PageRank vector around `source`
    (reference: lgc.hpp; α is the teleport constant), float32 on A's
    device. Needs A's CSR."""
    if A.row_ptr is None:
        raise ValueError("lgc pulls over A's CSR; this Matrix is CSC-only")
    p, _, _ = _lgc_loop(A, source, alpha=alpha, eps=eps,
                        max_niter=desc.max_niter)
    return dense_result(A.nrows, p)


def lgc_cpu(A: Matrix, source: int, alpha: float = 0.15, eps: float = 1e-6,
            max_niter: int = 200):
    from .reference import lgc_cpu as _impl

    return _impl(A, source, alpha, eps, max_niter)
