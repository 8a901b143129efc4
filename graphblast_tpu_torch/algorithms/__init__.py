"""Algorithm library. Ported so far: BFS (pull-only), PageRank and their
NumPy goldens."""

from .bfs import bfs, bfs_cpu
from .pr import pr, pr_cpu, prepare_pr_matrix
from . import reference
