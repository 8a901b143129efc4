"""The distributed layer over torch.distributed (counterpart of
graphblast_tpu/parallel): a 1D edge partition, one rank a block, with
all-gather pulls, the owner-routed dense push and the owner-bucketed
sparse push (parallel/ops.py); the ring and 2D layouts (ring.py,
partition2d.py); and BFS (pull, stepped and fused direction-optimized),
SSSP, CC, PageRank (all-gather, ring and 2D), LGC, TC, MIS, IS colouring
and the pseudo-diameter over them (algorithms.py); the partition cache
(partition.py) and the communication accounting (accounting.py). NCCL on
cards, gloo on the CPU; `bootstrap.launch` runs P ranks on one machine
(the tests use 4 gloo ranks)."""

from . import accounting, ops
from .algorithms import (bfs_dist, cc_dist, diameter_dist, gc_dist, lgc_dist,
                         make_bfs_dist, make_cc_dist, make_gc_dist,
                         make_lgc_dist, make_mis_dist, make_pr_2d_dist,
                         make_pr_dist, make_pr_ring_dist, make_sssp_dist,
                         mis_dist, pr_dist, sssp_dist, tc_dist, tc_prepare)
from .bootstrap import global_mesh, init_distributed, launch
from .partition import (ShardedMatrix, partition, partition_cached,
                        shard_cache_path, shard_vector)
from .partition2d import Sharded2D, mxv_2d, partition_2d
from .ring import RingShardedMatrix, mxv_ring, partition_ring, ring_mxv_pull
