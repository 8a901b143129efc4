"""Tracing hooks (counterpart of graphblast_tpu/utils/profiling.py).

The reference's timing subsystem: GpuTimer (backend/cuda/util.hpp:92-120)
is `TightTimer` in algorithms/common.py; the cudaProfilerStart/Stop hooks
(example/gbfs.cu:98,106) are `trace()` below, a torch.profiler trace of the
host and, on a card, the device, exported as a Chrome trace. The CLI
drivers expose it as --profile <dir>. `annotate` names the program's own
spans in such a trace (the BFS and PageRank loops, the dispatch's host
read, the push and the pull); it costs one check when no profiler runs.
`MemorySteps` records the card's memory by step of a Matrix build (the
`steps=` of `Matrix.from_coo`).
"""
from __future__ import annotations

import contextlib
import os
import time

from torch.autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:      # older torch: spans are no-ops
    _RecordFunctionFast = None

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the body when log_dir is set, and write the trace to
    <log_dir>/trace.json (open it in chrome://tracing or ui.perfetto.dev).

    Usage:
        with trace("prof"):
            run_benchmark()
    """
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span on the calling thread: `with annotate("gb.push"): ...`.

    With no profiler running it returns one shared no-op context manager,
    which allocates and records nothing. Under a profiler (`trace()`, or
    any torch.profiler.profile) it returns a `_RecordFunctionFast` range: a
    host op on the profiler's clock, nested in the span that encloses it.
    Unlike record_function it is no user annotation, so on a card the
    profiler makes no device-side copy of it, and the device's busy time
    in a trace holds kernels and copies only. Where the installed torch
    lacks `_RecordFunctionFast`, every span is the no-op."""
    if _RecordFunctionFast is None or not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


class MemorySteps:
    """The card's memory and time by step of a piece of work, such as a
    Matrix build (`Matrix.from_coo(..., steps=MemorySteps())`): call the
    object with a step's name as the step ends. Each row of `rows` is
    (name, the most allocated during the step above what was allocated
    when the object was made, in bytes, and the step's seconds). Reads
    torch.cuda's peak counter, which it resets at each step; needs a
    card."""

    def __init__(self, device="cuda"):
        import torch

        self.device = torch.device(device)
        torch.cuda.synchronize(self.device)
        self.base = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.rows = []
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.rows.append((name, torch.cuda.max_memory_allocated(self.device)
                          - self.base, now - self._t))
        torch.cuda.reset_peak_memory_stats(self.device)
        self._t = now

    def peak(self, names=None) -> int:
        """The most allocated over the steps (those in `names`, if given)."""
        return max(b for n, b, _ in self.rows if names is None or n in names)

    def lines(self, label: str, nnz: int) -> list:
        """One printable line a step: bytes, bytes an edge of `nnz`, s."""
        return [f"{label} {name}: {b} B the most allocated above the start, "
                f"{b / max(nnz, 1):.2f} B an edge, {s:.3f} s"
                for name, b, s in self.rows]
