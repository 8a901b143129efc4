"""The trace's reduction on hand-made intervals."""
import numpy as np

from gbench import trace


def _trace(dev, cpu, window=(0.0, 10.0)):
    return trace.Trace(window, [], np.array([d[1] for d in dev]),
                       np.array([d[2] for d in dev]), [d[0] for d in dev],
                       np.array([c[1] for c in cpu]),
                       np.array([c[2] for c in cpu]), [c[0] for c in cpu])


def test_union_merges_overlaps():
    iv = trace.union(np.array([3.0, 0.0, 1.0, 6.0]), np.array([4.0, 2.0, 1.5, 7.0]))
    assert iv.tolist() == [[0.0, 2.0], [3.0, 4.0], [6.0, 7.0]]


def test_busy_kernels_and_gaps():
    t = _trace([("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k1", 5.0, 6.0)],
               [("gbench.call", 0.0, 10.0), ("aten::item", 3.0, 5.0),
                ("aten::nonzero", 6.5, 9.0)])
    assert t.busy_s() == 4.0
    assert t.busy_s(1.5, 5.5) == 2.0
    assert t.kernel_s(["k1"]) == (3.0, 2)
    assert t.device_ops() == [["k1", 3.0], ["k2", 2.0]]
    # gaps 3-5 (the host in aten::item) and 6-10 (its middle in nonzero)
    assert t.idle_gaps() == [["aten::nonzero", 4.0], ["aten::item", 2.0]]
