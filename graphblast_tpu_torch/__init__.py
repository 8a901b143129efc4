"""graphblast_tpu_torch: the PyTorch + CUDA port of graphblast_tpu.

GraphBLAS-style graph analytics as sparse linear algebra over semirings,
written for an NVIDIA H100. The module names follow the JAX package
(`graphblast_tpu`), which stays the reference; this package imports neither
JAX nor it. Every Pallas kernel of the JAX package becomes a hand-written
CUDA kernel (sources in csrc/, built with nvcc at first use), each with a
plain PyTorch version that CPU tensors run.

Entry points run on "cuda" unless the caller passes `device=` (the tests
pass device="cpu"); a missing card raises.

Ported so far: the core types, the semiring catalog, the descriptor,
ingest (mmio, cache, rmat), Matrix and Vector, the pull-only mxv_dual and
BFS over the bitmap-pull kernel K1 (slice 1); PageRank over the value-pull
kernel that replaces K2 and K3, with the three operations of its matrix
prep and the dimension checks (slice 2); pull-only SSSP and FastSV CC over
the min/max monoid-pull kernel K4, with the postprocess epilogue of
mxv_dual (slice 3); the plan-less pull (spmv_pull, segops, take) over the
or-pull prefix count K5 and the gather K6, with MIS, graph colouring,
stepped BFS and CC at n >= 2^24 on it (slice 4); triangle counting, the
masked mxm and trace_mxm_transpose over the masked-intersection kernels T1
and T2; the push (SpMSpV) with PUSHONLY BFS and SSSP (slice 11); the
direction switch PUSHPULL, eager and lazy, so the default bfs and sssp run,
with diameter, `transpose` and the gbfs, gsssp and gdiameter drivers
(`graphblast_tpu_torch.utils`, `graphblast_tpu_torch.examples`; slice 12).
"""

from .types import Direction, INDEX_DTYPE, LoadBalanceMode, SparseFormat, Storage
from .descriptor import BFS_TUNED, DEFAULT, Descriptor
from .semiring import (
    ALL_BINARY_OPS,
    ALL_MONOIDS,
    ALL_SEMIRINGS,
    BinaryOp,
    LogicalOrAndSemiring,
    MaximumMultipliesSemiring,
    MinimumMultipliesSemiring,
    MinimumPlusSemiring,
    MinimumSelectSecondSemiring,
    Monoid,
    PlusDividesSemiring,
    PlusMinusSemiring,
    PlusMonoid,
    PlusMultipliesSemiring,
    Semiring,
    extract_add,
    extract_mul,
)
from .matrix import Matrix
from .vector import Vector
from .operations import (
    eWiseMult_matrix_scalar,
    mxm,
    reduce_matrix_to_vector,
    scale_matrix_rows,
    trace_mxm_transpose,
    transpose,
    tril,
)
from . import algorithms
from .algorithms import (cc, cc_cpu, diameter, gc, gc_cpu, mis, mis_cpu, pr,
                         pr_cpu, prepare_pr_matrix, sssp, sssp_cpu, tc,
                         tc_cpu, triangle_count, verify_cc, verify_gc,
                         verify_mis)

__version__ = "0.1.0"
