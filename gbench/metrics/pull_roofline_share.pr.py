"""Per cent of its roofline that PageRank's value pull reaches over the
traced calls: launches x the least time of one pull over P (the larger of
`gbench.roofline.value_pull_least`'s bytes and flops at the card's peaks)
over the value pull's device time (torch.profiler, the kernels of the
PlusTimes policy). Layer: kernels (ops/kernels/value_pull.py,
csrc/value_pull.cu)."""
from gbench import roofline
from gbench.readers import VALUE_PULL

COUNTERS = VALUE_PULL

KERNEL = ("PlusTimes",)


def read(run, st):
    ts, peaks = run.trace_summary, run.peaks
    launches = run.launches.get("value_pull", 0)
    if ts is None or peaks is None or not launches:
        return None
    device_s, kernels = ts.kernel_s(KERNEL)
    if device_s <= 0 or kernels < launches:
        return None
    g = run.graph
    nbytes, flops = roofline.value_pull_least(g.n, g.n, g.m)
    least = launches * roofline.least_seconds(peaks, nbytes, flops)
    return 100.0 * least / device_s
