"""Pulls an SSSP call that took K4's masked entry (the MinimumPlus pull
that skips the rows the distances settle and reads x and the weight only
at the frontier's columns): spmv_monoid.masked_launches over the traced
window, per call. Layer: kernels (ops/kernels/monoid_pull.py,
csrc/monoid_pull.cu). None on a program without the counter."""
from gbench.readers import launches_per_call

COUNTERS = {"monoid_pull_masked": (
    "graphblast_tpu_torch.ops.kernels.monoid_pull", "spmv_monoid",
    "masked_launches")}


def read(run, st):
    return launches_per_call(run, "monoid_pull_masked")
