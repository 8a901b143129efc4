"""Pushes a BFS call that took the push's last workspace tier (edge_cap
lanes, every one sorted): mxv_dual.top_tier_pushes over the traced window,
per call. Layer: push (ops/dispatch.py mxv_dual, pick_tier)."""
from gbench.readers import launches_per_call

COUNTERS = {"top_tier_pushes": ("graphblast_tpu_torch.ops.dispatch",
                                "mxv_dual", "top_tier_pushes")}


def read(run, st):
    return launches_per_call(run, "top_tier_pushes")
