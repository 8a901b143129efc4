"""On the card: a whole run of each cell at a small scale, traced and not,
correct, with every metric of the cell. Run there with
`python3 -m pytest gbench/tests -m cuda`."""
import pytest

from gbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs", "kron25-pr"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(tiny_root, cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = harness.run_cell(cell, 2**31 + 3, 0.5, trace, "cuda:0",
                           root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    bench = harness.load_bench(tiny_root)
    want = {m["name"] for m in harness.metrics_of(bench, cell, bool(trace))}
    if trace:
        assert out["device"]["busy_s"] > 0
        # the roofline shares are absent only where no card's peaks are known
        assert want - set(out["metrics"]) <= {"pull_roofline_share.bfs",
                                              "pull_roofline_share.pr"}
        for k in ("pull_roofline_share.bfs", "pull_roofline_share.pr"):
            assert out["metrics"].get(k, {"value": 0})["value"] <= 100
    else:
        assert set(out["metrics"]) == want
