"""Pushes an SSSP call whose degree total passed the push's second
workspace tier, so that it ran in slices of the frontier, each no larger
than that tier: mxv_dual.sliced_pushes over the traced window, per call.
Layer: push (ops/dispatch.py mxv_dual)."""
from gbench.readers import launches_per_call

COUNTERS = {"sliced_pushes": ("graphblast_tpu_torch.ops.dispatch",
                              "mxv_dual", "sliced_pushes")}


def read(run, st):
    return launches_per_call(run, "sliced_pushes")
