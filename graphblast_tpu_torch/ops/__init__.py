"""Sparse operations: mxv/vxm dispatch, pull helpers, the masked SpGEMM
and kernels."""

from .spgemm import (intersect_rows_reduce, intersect_rows_reduce_plain,
                     spgemm_masked, spgemm_masked_count,
                     spgemm_masked_count_plain, spgemm_masked_plain)
