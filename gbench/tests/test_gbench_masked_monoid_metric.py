"""masked_pulls_per_call.sssp: the reader on hand-made counts, on a program
without the counter, and on the tiny CPU run."""
import types

from gbench import harness

MASKED = harness.load_module(harness.ROOT, "metrics",
                             "masked_pulls_per_call.sssp")


def test_masked_monoid_reader_on_its_count():
    run = types.SimpleNamespace(latencies=[0.1] * 8,
                                launches={"monoid_pull_masked": 50})
    assert MASKED.read(run, None) == 6.25
    # a program without the counter (the parent of the masked entry)
    bare = types.SimpleNamespace(latencies=[0.1] * 8, launches={})
    assert MASKED.read(bare, None) is None
    assert MASKED.read(types.SimpleNamespace(latencies=[], launches={
        "monoid_pull_masked": 0}), None) is None


def test_masked_monoid_counter_is_the_programs():
    """The counter the reader declares exists on the program's wrapper,
    beside the one pulls_per_call.sssp reads."""
    counters = harness.declared_counters([MASKED])
    assert set(counters) == {"monoid_pull_masked"}
    got = harness._counters(counters)
    assert got == {"monoid_pull_masked": got["monoid_pull_masked"]}
    assert isinstance(got["monoid_pull_masked"], int)
    pulls = harness.load_module(harness.ROOT, "metrics",
                                "pulls_per_call.sssp")
    assert (harness.declared_counters([pulls])["monoid_pull"][:2]
            == counters["monoid_pull_masked"][:2])


def test_masked_monoid_pulls_in_the_tiny_traced_run(tiny_root):
    """The traced run on the CPU reports masked_pulls_per_call.sssp equal to
    pulls_per_call.sssp."""
    out = harness.run_cell("kron25-sssp", 2**31 + 17, 0.2, True, "cpu",
                           root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    assert (got["masked_pulls_per_call.sssp"]["value"]
            == got["pulls_per_call.sssp"]["value"])
