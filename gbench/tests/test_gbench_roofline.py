"""The byte counts of the roofline shares, on graphs counted by hand."""
import pytest
import torch

from gbench import graphs, roofline


def _star_path():
    # 0-1, 0-2, 0-3, 3-4: row 0 holds 1, 2, 3; row 3 holds 0, 4
    u = torch.tensor([0, 0, 0, 3], dtype=torch.int32)
    v = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    return graphs.canonical(u, v, 8)


def test_orpull_bytes_by_hand():
    g = _star_path()
    # BFS from 1: level 1 {1}, 2 {0}, 3 {2, 3}, 4 {4}; 5..7 unreached
    level = torch.tensor([2, 1, 3, 3, 4, 0, 0, 0])
    # the pull of iteration 2 (frontier {0}): open rows 2, 3, 4, 5, 6, 7.
    # Row 2 = [0]: 1 id to its hit; row 3 = [0, 4]: 1 id; row 4 = [3]: no
    # hit, 1 id; rows 5-7 have none. Pointers 2..8: 7 of 4 B. Three
    # bitmaps of 1 B.
    assert roofline.orpull_least_bytes(g, level, 2) == 4 * 3 + 4 * 7 + 3
    # iteration 3 (frontier {2, 3}): open rows 4..7; row 4 = [3] hits at
    # its first id; pointers 4..8: 5
    assert roofline.orpull_least_bytes(g, level, 3) == 4 * 1 + 4 * 5 + 3
    # iteration 1 (frontier {1}): open rows 0, 2..7. Row 0 = [1, 2, 3]
    # hits first; row 2 = [0], row 3 = [0, 4], row 4 = [3] miss: 1 + 1 + 2
    # + 1 ids; pointers 0, 1, 2..8: 9
    assert roofline.orpull_least_bytes(g, level, 1) == 4 * 5 + 4 * 9 + 3


def test_orpull_bytes_chunked_equals_whole(monkeypatch):
    g = _star_path()
    level = torch.tensor([2, 1, 3, 3, 4, 0, 0, 0])
    whole = [roofline.orpull_least_bytes(g, level, it) for it in (1, 2, 3)]
    monkeypatch.setattr(roofline, "chunks",
                        lambda m: graphs.chunks(m, 3))
    assert [roofline.orpull_least_bytes(g, level, it)
            for it in (1, 2, 3)] == whole


def test_value_pull_bytes_by_hand():
    nbytes, flops = roofline.value_pull_least(8, 8, 8)
    assert nbytes == 8 * 8 + 4 * 9 + 4 * 8 + 4 * 8
    assert flops == 16
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.least_seconds(peaks, 3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(peaks, 0, 67e12) == pytest.approx(1.0)
