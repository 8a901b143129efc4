"""The command refuses to run anywhere but on a card: without one it exits
non-zero and prints no result line."""
import os
import subprocess
import sys

import pytest

from gbench import harness
from gbench_tiny import make_root


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without")
    out = subprocess.run(
        [sys.executable, "-m", "gbench.run", "--workload", "kron25-bfs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refused_outside_a_checkout(tmp_path):
    """In a folder that holds only BENCHMARK.json and gbench/, the program
    is missing and the run fails with no result."""
    root = make_root(tmp_path)      # at a small scale, in case it ran
    out = subprocess.run(
        [sys.executable, "-c",
         "from gbench import harness; "
         "harness.run_cell('kron25-bfs', 1, 0.1, False, 'cpu')"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "graphblast_tpu_torch" in out.stderr
