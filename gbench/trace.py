"""The reduction of a torch.profiler trace to what the per-layer metrics
and the breakdown read: the device's busy intervals, kernel time by name,
the benchmark's own spans, and the idle gaps named by what the host did.

The benchmark marks its window and each call with record_function spans
named "gbench.window" and "gbench.call"; the program has no spans of its
own. Times are in seconds on the profiler's clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WINDOW, CALL = "gbench.window", "gbench.call"
# the gaps named in the breakdown: the longest this many
NAMED_GAPS = 2000


@dataclasses.dataclass
class Trace:
    window: tuple                 # (start, end) of the traced window
    calls: list                   # (start, end) of each call
    dev_start: np.ndarray         # device operations in the window
    dev_end: np.ndarray
    dev_name: list
    cpu_start: np.ndarray         # host operations, the spans included
    cpu_end: np.ndarray
    cpu_name: list

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self, lo=None, hi=None) -> np.ndarray:
        """The union of device activity, clipped to [lo, hi] (the window
        by default), as an (k, 2) array of disjoint sorted intervals."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        return union(s[keep], e[keep])

    def busy_s(self, lo=None, hi=None) -> float:
        iv = self.busy_intervals(lo, hi)
        return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0

    def kernel_s(self, names) -> tuple:
        """(seconds, launches) of the device operations whose names hold
        one of `names`."""
        pick = [i for i, k in enumerate(self.dev_name)
                if any(n in k for n in names)]
        if not pick:
            return 0.0, 0
        idx = np.asarray(pick)
        return float((self.dev_end[idx] - self.dev_start[idx]).sum()), len(pick)

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by = {}
        for k, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            by[k] = by.get(k, 0.0) + float(e - s)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host operation, seconds]]: the window's idle time in its
        longest gaps (NAMED_GAPS of them), summed by the innermost host
        operation that spans each gap's middle."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        starts = np.concatenate([[w0], busy[:, 1]]) if len(busy) else np.array([w0])
        ends = np.concatenate([busy[:, 0], [w1]]) if len(busy) else np.array([w1])
        length = ends - starts
        order = np.argsort(-length)[:NAMED_GAPS]
        order = order[length[order] > 0]
        by = {}
        for i in order:
            mid = 0.5 * (starts[i] + ends[i])
            cover = np.nonzero((self.cpu_start <= mid) & (self.cpu_end >= mid))[0]
            if len(cover):
                # nested host ops: the one that started last is innermost
                name = self.cpu_name[cover[np.argmax(self.cpu_start[cover])]]
            else:
                name = "no host operation"
            by[name] = by.get(name, 0.0) + float(length[i])
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def union(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the intervals [s, e]."""
    if len(s) == 0:
        return np.zeros((0, 2))
    o = np.argsort(s, kind="stable")
    s, e = s[o], e[o]
    reach = np.maximum.accumulate(e)
    # a new interval starts where s passes everything before it
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    return np.stack([s[idx], ends], axis=1)


def _events(prof):
    """(name, is_device, start_s, end_s) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            t0, dt = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:      # releases that count in microseconds
            t0, dt = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        out.append((ev.name(), ev.device_type() == DeviceType.CUDA,
                    t0, t0 + dt))
    return out


def reduce(prof):
    """The Trace of a finished torch.profiler.profile, or None where it
    holds no window span."""
    dev, cpu, calls, window = [], [], [], None
    for name, is_dev, t0, t1 in _events(prof):
        if is_dev:
            # device-side copies of the benchmark's spans are no work
            if not name.startswith("gbench."):
                dev.append((name, t0, t1))
            continue
        if name == WINDOW:
            window = (t0, t1)
        elif name == CALL:
            calls.append((t0, t1))
        cpu.append((name, t0, t1))
    if window is None:
        return None
    w0, w1 = window
    dev = [d for d in dev if d[2] > w0 and d[1] < w1]
    calls.sort()
    return Trace(window, calls,
                 np.array([d[1] for d in dev]), np.array([d[2] for d in dev]),
                 [d[0] for d in dev],
                 np.array([c[1] for c in cpu]), np.array([c[2] for c in cpu]),
                 [c[0] for c in cpu])
