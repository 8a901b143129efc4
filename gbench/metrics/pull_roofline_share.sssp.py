"""Per cent of its roofline that K4, SSSP's Minimum-Plus monoid pull,
reaches over the traced calls: K4 launches x the least time of one pull
over A's CSC (`gbench.roofline_monoid.monoid_pull_least_s` at the card's
peaks) over K4's device time (torch.profiler, the kernels of the
MonoidFold policy). Layer: kernels (ops/kernels/monoid_pull.py,
csrc/monoid_pull.cu)."""
from gbench import roofline_monoid

COUNTERS = {"monoid_pull": ("graphblast_tpu_torch.ops.kernels.monoid_pull",
                            "spmv_monoid", "launches")}

KERNEL = ("MonoidFold",)


def read(run, st):
    ts = run.trace_summary
    launches = run.launches.get("monoid_pull", 0)
    if ts is None or run.peaks is None or not launches:
        return None
    device_s, kernels = ts.kernel_s(KERNEL)
    if device_s <= 0 or kernels < launches:
        return None
    g = run.graph
    least = roofline_monoid.monoid_pull_least_s(g.n, g.n, g.m, run.peaks)
    return 100.0 * launches * least / device_s
