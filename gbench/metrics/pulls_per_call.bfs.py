"""Pulls a BFS call: K1 launches (spmv_bitmap_pull.launches) over the
traced window, per call; the other iterations pushed. Layer: direction
dispatch (ops/dispatch.py mxv_dual)."""
from gbench.readers import BITMAP_PULL, launches_per_call

COUNTERS = BITMAP_PULL


def read(run, st):
    return launches_per_call(run, "bitmap_pull")
