"""Per cent of its roofline that K1, BFS's masked or-pull, reaches over
the traced calls: the least time of every pull (bytes at the card's peak
rate, `gbench.roofline.orpull_least_bytes`, from each call's levels and
the iteration of each pull) over K1's device time (torch.profiler, the
kernels of the BitCount policy). Layer: kernels (ops/kernels/bitmap_pull.py,
csrc/bitmap_pull.cu)."""
from gbench import roofline
from gbench.readers import pull_iterations

KERNEL = ("BitCount",)


def read(run, st):
    ts, peaks = run.trace_summary, run.peaks
    if ts is None or peaks is None or not getattr(st, "words", None):
        return None
    pulls = pull_iterations(st)
    device_s, kernels = ts.kernel_s(KERNEL)
    if not pulls or device_s <= 0 or kernels < len(pulls):
        return None
    least = sum(roofline.orpull_least_bytes(run.graph, st.levels[k], it)
                for k, it in pulls) / peaks["bytes_per_s"]
    return 100.0 * least / device_s
