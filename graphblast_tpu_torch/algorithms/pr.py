"""PageRank (counterpart of graphblast_tpu/algorithms/pr.py; reference:
graphblas/algorithm/pr.hpp:15-94 + the matrix prep of example/gpr.cu:82-98).

The matrix prep (example/gpr.cu) scales A ← α·A/outdegree and the algorithm
iterates
    p' = vxm(PlusMultiplies, p, A) + (1-α)/n        # rank propagation
    err = ‖p' - p‖₂
from p₀ = 1/n, with `it` starting at 1, while err > eps and it <= max_niter.

Both modes run the vxm pull over the α/outdegree-scaled CSC plan that
`prepare_pr_plan` builds on the host, through the value-pull kernel (K2/K3
of the JAX package), and read `err` on the host once per iteration; the
JAX package's fused mode keeps the loop on the device with no host sync,
and its stepped mode runs `spmv_pull` on `prepare_pr_matrix`'s result.
Here the two modes run the same loop, and "stepped" also prints the
reference's per-iteration row when desc.timing is set.
"""
from __future__ import annotations

import numpy as np
import torch

from ..descriptor import DEFAULT, Descriptor
from ..matrix import Matrix
from ..operations import (eWiseMult_matrix_scalar, reduce_matrix_to_vector,
                          scale_matrix_rows)
from ..ops.kernels.value_pull import ValuePlan, plan_for, spmv_value_pull
from ..semiring import (PlusDividesSemiring, PlusMonoid,
                        PlusMultipliesSemiring)
from ..utils.profiling import annotate
from ..vector import Vector
from .common import TightTimer, dense_result, print_iter_row


def prepare_pr_matrix(A: Matrix, alpha: float = 0.85) -> Matrix:
    """Matrix prep: A ← α · A / outdegree(row) (example/gpr.cu:82-90:
    reduce to outdegrees, eWiseMult by α, eWiseMult-divide by
    outdegrees)."""
    outdeg = reduce_matrix_to_vector(A, PlusMonoid)
    scaled = eWiseMult_matrix_scalar(A, PlusMultipliesSemiring, alpha)
    return scale_matrix_rows(scaled, outdeg, PlusDividesSemiring)


def prepare_pr_plan(A: Matrix, alpha: float = 0.85):
    """The α-scaled vxm value plan, built on the host: the CSC with each
    value scaled by α/outdeg(row), i.e. the vxm pull of
    prepare_pr_matrix(A)'s result. The out-degree is the weighted row sum,
    in float64. None when A lacks its CSR or its CSC."""
    host_csr, host_csc = A.host_csr(), A.host_csc()
    if host_csr is None or host_csc is None:
        return None
    ptr, _, rvals = host_csr
    n = A.nrows
    rows = np.repeat(np.arange(n), np.diff(ptr))
    outdeg = np.bincount(rows, weights=rvals.astype(np.float64),
                         minlength=n)
    scale = np.where(outdeg > 0, alpha / np.maximum(outdeg, 1e-300), 0.0)
    _, cind, cval = host_csc
    val_scaled = (cval.astype(np.float64) * scale[cind]).astype(np.float32)
    return plan_for(A, transpose=True, host_val=val_scaled)


def _pr_step(A: Matrix, p: torch.Tensor, alpha: float, plan: ValuePlan):
    # vxm(p_swap, PlusMultiplies, p_prev, A), pr.hpp:69-71: the vxm pull
    p_swap = spmv_value_pull(plan, p)
    # eWiseAdd(p, PlusMultiplies, p_swap, (1-alpha)/n), pr.hpp:72-73
    p_new = p_swap + (1.0 - alpha) / A.nrows
    # error = sqrt Σ (p-p_prev)², pr.hpp:76-81
    err = torch.linalg.vector_norm(p_new - p)
    return p_new, err


def _pr_fused(A: Matrix, plan: ValuePlan, *, alpha: float, eps: float,
              max_niter: int, timing: int = 0):
    """The convergence loop. Returns (p, iterations run, last err). Under
    a profiler each iteration is a "gb.pr.iter" span holding its host read
    of err, "gb.pr.read"."""
    n = A.nrows
    p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=A.device)
    timer = TightTimer() if timing else None
    it, err = 1, 1.0
    while err > eps and it <= max_niter:
        with annotate("gb.pr.iter"):
            if timing:
                timer.start()
            p, err_t = _pr_step(A, p, alpha, plan)
            with annotate("gb.pr.read"):
                err = float(err_t)      # the one host sync of the iteration
            if timing:
                print_iter_row(it, f"{err:.3e}", n, n, False, timer.stop(p),
                               timing)
        it += 1
    return p, it - 1, err


def pr(A: Matrix, alpha: float = 0.85, eps: float = 1e-6,
       desc: Descriptor = DEFAULT, mode: str = "fused",
       prepared: bool = False) -> Vector:
    """PageRank vector, float32, on A's device. `prepared=True` means A is
    already α-scaled column-stochastic (the reference pr() contract) and its
    stored CSC values are pulled as they are; otherwise the α/outdegree
    scaling goes into the plan. Raises NotImplementedError when A lacks its
    CSC or, unprepared, its CSR. Any mode but "fused" runs stepped, as in
    the JAX package."""
    plan = (plan_for(A, transpose=True) if prepared
            else prepare_pr_plan(A, alpha))
    if plan is None:
        raise NotImplementedError(
            "PageRank needs both orientations of A (it pulls over the CSC "
            "and scales by the CSR's out-degrees); the JAX package has no "
            "route for a one-sided matrix either")
    p, _, _ = _pr_fused(A, plan, alpha=alpha, eps=eps,
                        max_niter=desc.max_niter,
                        timing=desc.timing if mode != "fused" else 0)
    return dense_result(A.nrows, p)


def pr_cpu(A: Matrix, alpha: float = 0.85, eps: float = 1e-6,
           max_niter: int = 100):
    from .reference import pr_cpu as _impl

    return _impl(A, alpha, eps, max_niter)
