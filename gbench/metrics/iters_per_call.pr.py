"""PageRank iterations a call: value-pull launches
(spmv_value_pull.launches) over the traced window, per call, one an
iteration. Layer: algorithm loop (algorithms/pr.py)."""
from gbench.readers import VALUE_PULL, launches_per_call

COUNTERS = VALUE_PULL


def read(run, st):
    return launches_per_call(run, "value_pull")
