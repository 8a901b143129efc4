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
direction switch PUSHPULL, so the default bfs and sssp run, with
diameter, `transpose` and the gbfs, gsssp and gdiameter drivers
(`graphblast_tpu_torch.utils`, `graphblast_tpu_torch.examples`; slice 12);
the GraphBLAS operations surface (mxv/vxm with masks and accumulators,
eWise, apply, assign, extract, reduce, scale, the unmasked ESC SpGEMM,
spmm and DenseMatrix) and local graph clustering with its glgc driver
(slice 13); then the gpr, gcc, gmis, ggc, ggc_cusparse and gtc drivers,
the native C++ ingest (`graphblast_tpu_torch.native`) and the first half
of the distributed layer on torch.distributed (`graphblast_tpu_torch.
parallel`: the 1D partition, the pull and push collectives, BFS, SSSP, CC,
PageRank, LGC and the diameter, and examples/scaling.py); and its second
half: the sparse owner-bucketed push and the fused direction-optimized
BFS, the ring and 2D layouts with their PageRank, the ring-staged TC, MIS
and IS colouring, the partition cache and the communication accounting
with its reader examples/comm_report.py. The port now does what the JAX
package does, but for its TPU-only switches and diagnostics. The push
runs on one frontier protocol, both images valid every call, with three
routes (`ops/dispatch.push_route`): the bitmap push P for BFS, scatter
pushes over slices of the frontier for SSSP, and a workspace sized from
the frontier's degree total for every other push.
"""

from .types import (Direction, INDEX_DTYPE, Info, LoadBalanceMode,
                    SparseFormat, Storage)
from .descriptor import BFS_TUNED, DEFAULT, Descriptor
from .semiring import (
    ALL_BINARY_OPS,
    ALL_MONOIDS,
    ALL_SEMIRINGS,
    BinaryOp,
    Monoid,
    Semiring,
    extract_add,
    extract_mul,
    # binary ops
    LogicalOr, LogicalAnd, LogicalXor, Equal, NotEqualTo, Greater, Less,
    GreaterEqual, LessEqual, First, Second, Minimum, Maximum, Plus, Minus,
    Multiplies, Divides, SelectSecond,
    # monoids
    PlusMonoid, MultipliesMonoid, MinimumMonoid, MaximumMonoid,
    LogicalOrMonoid, LogicalAndMonoid, GreaterMonoid, CustomLessMonoid,
    NotEqualToMonoid,
    # semirings
    LogicalOrAndSemiring, PlusMultipliesSemiring, MinimumPlusSemiring,
    MaximumMultipliesSemiring, PlusDividesSemiring, PlusGreaterSemiring,
    GreaterPlusSemiring, PlusMinusSemiring, PlusLessSemiring,
    CustomLessPlusSemiring, MinimumMultipliesSemiring,
    MultipliesMultipliesSemiring, NotEqualToPlusSemiring,
    MinimumSelectSecondSemiring, PlusNotEqualToSemiring,
    CustomLessLessSemiring, MinimumNotEqualToSemiring,
)
from .matrix import Matrix
from .dense_matrix import DenseMatrix, gemm, gemv
from .vector import Vector
from .operations import (
    apply,
    apply_matrix,
    apply_vxm,
    assign,
    assign_indexed,
    assign_matrix,
    assign_matrix_col,
    assign_matrix_row,
    assign_matrix_scalar,
    assign_scatter,
    eWiseAdd,
    eWiseAdd_matrix,
    eWiseMult,
    eWiseMult_matrix_scalar,
    extract,
    extract_col,
    extract_gather,
    extract_matrix,
    mxm,
    mxm_dense,
    mxv,
    reduce_matrix,
    reduce_matrix_to_vector,
    reduce_vector,
    scale_matrix,
    scale_matrix_cols,
    scale_matrix_rows,
    scale_vector,
    scatter,
    trace_mxm_transpose,
    transpose,
    tril,
    vxm,
)
from . import algorithms
from .algorithms import (cc, cc_cpu, diameter, gc, gc_cpu, lgc, lgc_cpu, mis,
                         mis_cpu, pr, pr_cpu, prepare_pr_matrix, sssp,
                         sssp_cpu, tc, tc_cpu, triangle_count, verify_cc,
                         verify_gc, verify_mis)

__version__ = "0.1.0"
