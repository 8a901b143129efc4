"""bitmap_pushes_per_call.bfs: the reader on hand-made counts, on a program
without the counter, and on the tiny CPU run."""
import types

import pytest

from gbench import harness

BITMAP = harness.load_module(harness.ROOT, "metrics",
                             "bitmap_pushes_per_call.bfs")


def test_bitmap_pushes_reader_on_its_count():
    run = types.SimpleNamespace(latencies=[0.1] * 4,
                                launches={"bitmap_pushes": 18})
    assert BITMAP.read(run, None) == 4.5
    # a program without the counter (the parent of the bitmap push)
    bare = types.SimpleNamespace(latencies=[0.1] * 4, launches={})
    assert BITMAP.read(bare, None) is None
    assert BITMAP.read(types.SimpleNamespace(latencies=[], launches={
        "bitmap_pushes": 0}), None) is None


@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs"])
def test_bitmap_pushes_in_the_tiny_traced_run(tiny_root, cell):
    """The traced run on the CPU reports bitmap_pushes_per_call.bfs: a
    whole count over the window, at most an iteration a call."""
    out = harness.run_cell(cell, 2**31 + 13, 0.2, True, "cpu",
                           root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    pushes = got["bitmap_pushes_per_call.bfs"]["value"]
    assert 0 < pushes <= got["iters_per_call.bfs"]["value"]
    total = pushes * out["attempted"]
    assert total == pytest.approx(round(total))
