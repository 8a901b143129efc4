"""Pushes a BFS call that took the bitmap push (the structure-only push
that marks a bitmap of new vertices, with no sort and no workspace tier):
mxv_dual.bitmap_pushes over the traced window, per call. Layer: push
(ops/dispatch.py mxv_dual, ops/kernels/bitmap_push.py)."""
from gbench.readers import launches_per_call

COUNTERS = {"bitmap_pushes": ("graphblast_tpu_torch.ops.dispatch",
                              "mxv_dual", "bitmap_pushes")}


def read(run, st):
    return launches_per_call(run, "bitmap_pushes")
