"""What several per-layer metric readers share. A reader returns None
where its run holds nothing for it to read; the harness then leaves the
metric out of the result line."""
from __future__ import annotations

import torch

# launch counters of the program's kernel wrappers, as a reader or an entry
# declares the ones it reads in its COUNTERS: {key: (module, function,
# attribute)}; the harness takes each over the window into run.launches
BITMAP_PULL = {"bitmap_pull": ("graphblast_tpu_torch.ops.kernels.bitmap_pull",
                               "spmv_bitmap_pull", "launches")}
VALUE_PULL = {"value_pull": ("graphblast_tpu_torch.ops.kernels.value_pull",
                             "spmv_value_pull", "launches")}


def idle_share(run):
    """Per cent of the traced window in which no operation ran on the
    device: 1 - (union of device activity) / window."""
    ts = run.trace_summary
    if ts is None or not len(ts.dev_start) or ts.window_s <= 0:
        return None
    return 100.0 * (1.0 - ts.busy_s() / ts.window_s)


def traced_levels(st) -> dict:
    """{call: its levels} of a traced BFS window, held as int8; empty where
    there are none, or where a level passed 127 and wrapped."""
    levels = getattr(st, "levels", None) or {}
    if any(int(lv.min()) < 0 for lv in levels.values()):
        return {}
    return levels


def call_depths(st) -> list:
    """The deepest level of each traced BFS call's result, in call order:
    the iterations its loop ran."""
    levels = traced_levels(st)
    return [int(levels[k].max()) for k in sorted(levels)]


def launches_per_call(run, counter: str):
    """Launches of a kernel wrapper over the traced window, per call."""
    if counter not in run.launches or not run.latencies:
        return None
    return run.launches[counter] / len(run.latencies)


def pull_iterations(st) -> list:
    """(call, iteration) of each K1 launch of a traced BFS window, from the
    frontier bitmaps the entry recorded (st.words) and the calls' levels
    (st.levels): the iteration is the level of any vertex in the frontier
    that the pull read."""
    out, levels = [], traced_levels(st)
    if not levels:
        return out
    for k, words in sorted(st.words.items()):
        for w in words:
            nz = torch.nonzero(w).flatten()
            if not len(nz):
                continue
            wi = int(nz[0])
            word = int(w[wi]) & 0xFFFFFFFF
            bit = (word & -word).bit_length() - 1
            out.append((k, int(levels[k][32 * wi + bit])))
    return out
