"""Triangle-counting driver (counterpart of examples/gtc.py; reference:
example/gtc.cu, with its tril preprocessing at gtc.cu:80-82). `python -m
graphblast_tpu_torch.examples.gtc <graph> [flags]`: L = tril(A) once, then
tc(L) against tc_cpu(L). The port's tc(L) takes no descriptor (ROADMAP,
"Differences")."""
import sys

import numpy as np

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import reference, tc
    from ..operations import tril

    state = {}

    def lower(A):
        if "L" not in state:
            state["L"] = tril(A)
        return state["L"]

    def run(A, args, desc):
        return np.asarray([tc(lower(A))])

    def cpu(A, args):
        return np.asarray([reference.tc_cpu(lower(A))])

    def ver(A, got, want):
        ok = int(got[0]) == int(want[0])
        print(f"TC: ntris={int(got[0])} golden={int(want[0])} "
              f"{'CORRECT' if ok else 'INCORRECT'}")
        return ok

    return run_driver("gtc", "triangle counting (masked SpGEMM)", run, cpu,
                      ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
