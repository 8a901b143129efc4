"""masked_pulls_per_call.bfs: the reader on hand-made counts, on a program
without the counter, and on the tiny CPU run."""
import types

import pytest

from gbench import harness

MASKED = harness.load_module(harness.ROOT, "metrics",
                             "masked_pulls_per_call.bfs")


def test_masked_pulls_reader_on_its_count():
    run = types.SimpleNamespace(latencies=[0.1] * 4,
                                launches={"bitmap_pull_masked": 10})
    assert MASKED.read(run, None) == 2.5
    # a program without the counter (the parent of the masked entry)
    bare = types.SimpleNamespace(latencies=[0.1] * 4, launches={})
    assert MASKED.read(bare, None) is None
    assert MASKED.read(types.SimpleNamespace(latencies=[], launches={
        "bitmap_pull_masked": 0}), None) is None


def test_masked_pulls_counter_is_the_programs():
    """The counter the reader declares exists on the program's wrapper,
    beside the one pulls_per_call.bfs reads."""
    counters = harness.declared_counters([MASKED])
    assert set(counters) == {"bitmap_pull_masked"}
    got = harness._counters(counters)
    assert got == {"bitmap_pull_masked": got["bitmap_pull_masked"]}
    assert isinstance(got["bitmap_pull_masked"], int)


@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs"])
def test_masked_pulls_in_the_tiny_traced_run(tiny_root, cell):
    """The traced run on the CPU reports masked_pulls_per_call.bfs equal to
    pulls_per_call.bfs: every BFS pull takes the masked entry."""
    out = harness.run_cell(cell, 2**31 + 17, 0.2, True, "cpu",
                           root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    assert (got["masked_pulls_per_call.bfs"]["value"]
            == got["pulls_per_call.bfs"]["value"])
