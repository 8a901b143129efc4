"""The distributed layer over torch.distributed (counterpart of
graphblast_tpu/parallel): a 1D edge partition, one rank a block, with
all-gather pulls and the owner-routed push (parallel/ops.py), and BFS,
SSSP, CC, PageRank, LGC and the pseudo-diameter over it. NCCL on cards,
gloo on the CPU; `bootstrap.launch` runs P ranks on one machine (the tests
use 4 gloo ranks). The rest of the JAX layer (the partition cache, the
sparse push exchange, the ring and 2D layouts, the fused dual-direction
BFS, TC, MIS and colouring) and the communication accounting wait for
ROADMAP item 10b; the algorithm entries among them raise
NotImplementedError here."""

from . import ops
from .algorithms import (bfs_dist, cc_dist, diameter_dist, gc_dist, lgc_dist,
                         make_bfs_dist, make_cc_dist, make_gc_dist,
                         make_lgc_dist, make_mis_dist, make_pr_2d_dist,
                         make_pr_dist, make_pr_ring_dist, make_sssp_dist,
                         mis_dist, pr_dist, sssp_dist, tc_dist, tc_prepare)
from .bootstrap import global_mesh, init_distributed, launch
from .partition import ShardedMatrix, partition, shard_vector
