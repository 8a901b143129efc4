"""Per cent of the push's workspace lanes that carried an edge, over the
traced window: 100 x the frontiers' degree totals summed over the pushes
(mxv_dual.push_edges) / the lanes of the tier each push took
(mxv_dual.push_lanes). Layer: push (ops/dispatch.py mxv_dual -> _push,
ops/spmspv.py)."""
DISPATCH = "graphblast_tpu_torch.ops.dispatch"
COUNTERS = {"push_edges": (DISPATCH, "mxv_dual", "push_edges"),
            "push_lanes": (DISPATCH, "mxv_dual", "push_lanes")}


def read(run, st):
    lanes = run.launches.get("push_lanes")
    if not lanes or "push_edges" not in run.launches:
        return None
    return 100.0 * run.launches["push_edges"] / lanes
