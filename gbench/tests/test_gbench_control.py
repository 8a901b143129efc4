"""The control of each cell, at a scale the CPU holds: a run through the
harness with the reference in the program's place, in the step below what
the configuration states, comes out not correct. On the card the same runs
at the cells' own sizes are `python3 -m gbench.control` (PERF.md)."""
import pytest

from gbench import control, harness


@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs", "kron25-pr"])
def test_control_fails_the_check(tiny_root, cell):
    for seed in (1, 2, 2**31 + 5):
        out = control.run(cell, seed, "cpu", root=tiny_root)
        assert not out["correct"], out["checks"]
        assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["kron25-bfs", "urand25-bfs", "kron25-pr"])
def test_program_passes_the_check(tiny_root, cell):
    out = harness.run_cell(cell, 2**31 + 9, 0.2, False, "cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
