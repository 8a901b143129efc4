"""Tracing hooks (counterpart of graphblast_tpu/utils/profiling.py).

The reference's timing subsystem: GpuTimer (backend/cuda/util.hpp:92-120)
is `TightTimer` in algorithms/common.py; the cudaProfilerStart/Stop hooks
(example/gbfs.cu:98,106) are `trace()` below, a torch.profiler trace of the
host and, on a card, the device, exported as a Chrome trace. The CLI
drivers expose it as --profile <dir>.
"""
from __future__ import annotations

import contextlib
import os


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
    """A named span inside a trace (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)
