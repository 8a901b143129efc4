"""Triangle counting (counterpart of graphblast_tpu/algorithms/tc.py;
reference: graphblas/algorithm/tc.hpp:15-54 and the example program's
preprocessing, example/gtc.cu:80-82):

    L = tril(A)                                  # a host filter
    ntris = Σ_{(i,j)∈L} |N_L(i) ∩ N_L(j)|        # mxm(mask=L, L, Lᵀ), summed

One route at every size: the structural count `spgemm_masked_count(L, L, L,
transpose_b=True)`, one launch of T1 on the card. The JAX package's dense
int8 block product (n ≤ GRB_TC_DENSE_LIMIT) and its GRB_TC_COUNT switch to
the general mxm route are TPU workarounds and are not ported; the general
route stays reachable as `mxm(L, L, PlusMultiplies, mask=L,
desc=Descriptor(transpose_inp1=True))`.
"""
from __future__ import annotations

from ..matrix import Matrix
from ..operations import tril
from ..ops.spgemm import spgemm_masked_count
from .reference import tc_cpu  # noqa: F401  (the host golden)


def tc(L: Matrix) -> int:
    """Triangle count of a strictly lower-triangular L (the reference's tc()
    contract: the caller runs tril first), an exact Python int."""
    return spgemm_masked_count(L, L, L, transpose_b=True)


def triangle_count(A: Matrix) -> int:
    """tril, then tc, on a symmetric adjacency matrix."""
    return tc(tril(A))
