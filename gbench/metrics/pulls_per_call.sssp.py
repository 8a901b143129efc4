"""Pulls an SSSP call: K4 launches (spmv_monoid.launches) over the traced
window, per call; the other relaxations pushed. Layer: direction dispatch
(ops/dispatch.py mxv_dual)."""
from gbench.readers import launches_per_call

COUNTERS = {"monoid_pull": ("graphblast_tpu_torch.ops.kernels.monoid_pull",
                            "spmv_monoid", "launches")}


def read(run, st):
    return launches_per_call(run, "monoid_pull")
