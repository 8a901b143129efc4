"""Algorithm library: BFS and SSSP (push, pull and direction-optimized),
PageRank, CC (FastSV), MIS, graph colouring, triangle counting, local
graph clustering and the BFS pseudo-diameter, with their NumPy goldens."""

from .bfs import bfs, bfs_cpu
from .cc import cc, cc_cpu, verify_cc
from .diameter import diameter
from .gc import gc, gc_cpu, verify_gc
from .lgc import lgc, lgc_cpu
from .mis import mis, mis_cpu, mis_inner, verify_mis
from .pr import pr, pr_cpu, prepare_pr_matrix
from .sssp import sssp, sssp_cpu
from .tc import tc, tc_cpu, triangle_count
from . import reference
