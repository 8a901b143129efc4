"""The control of each cell's check: a run of the cell through the
harness, with the reference put in the program's place in the step below
what the configuration states, at the cell's own sizes. Prints, for each
seed, whether the run came out correct and the numbers its check compared;
exits 0 only where every control came out not correct.

    python3 -m gbench.control --workload <cell> --seeds <n> [<n> ...]

BFS states exact levels and no precision, so its control breaks that
guarantee: the deepest level is reported unreached, as a BFS would that
stops once its frontier has shrunk to a tail. PageRank states float32, so
its control runs the iteration with p and the scaled edges in bfloat16.
The control's window is the traffic's "sample" calls, as many as a run
compares by level or by value; neither control depends on time.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from gbench import harness


def run(workload: str, seed: int, device, root: str = harness.ROOT,
        bench=None) -> dict:
    """The result of one control run of `workload`."""
    return harness.run_cell(workload, seed, 0.0, False, device, root=root,
                            bench=bench, control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gbench.control: no CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in args.seeds:
        out = run(args.workload, seed, "cuda:0")
        failed_all &= not out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
