"""Pulls a BFS call that took K1's masked entry (the or-pull that reads
the visited mask itself and stops each open row at its first frontier
neighbour): spmv_bitmap_pull.masked_launches over the traced window, per
call. Layer: kernels (ops/kernels/bitmap_pull.py, csrc/bitmap_pull.cu).
None on a program without the counter."""
from gbench.readers import launches_per_call

COUNTERS = {"bitmap_pull_masked": (
    "graphblast_tpu_torch.ops.kernels.bitmap_pull", "spmv_bitmap_pull",
    "masked_launches")}


def read(run, st):
    return launches_per_call(run, "bitmap_pull_masked")
