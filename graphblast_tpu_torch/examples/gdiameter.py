"""Diameter driver (counterpart of examples/gdiameter.py; reference:
example/gdiameter.cu). `python -m graphblast_tpu_torch.examples.gdiameter
<graph> --source_start S --source_end E [flags]`."""
import sys

import numpy as np

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import diameter, reference

    def run(A, args, desc):
        d, s = diameter(A, args.source_start, args.source_end, desc=desc)
        return np.asarray([d, s])

    def cpu(A, args):
        eccs = [int(reference.bfs_cpu(A, s).max()) - 1
                for s in range(args.source_start, args.source_end)]
        return np.asarray([max(eccs)])

    def ver(A, got, want):
        ok = int(got[0]) == int(want[0])
        print(f"DIAMETER: {int(got[0])} (source {int(got[1])}) "
              f"{'CORRECT' if ok else 'INCORRECT'}")
        return ok

    return run_driver("gdiameter", "pseudo-diameter BFS sweep", run, cpu,
                      ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
