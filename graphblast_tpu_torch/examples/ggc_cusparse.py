"""Independent-set graph-colouring driver (counterpart of
examples/ggc_cusparse.py; reference: example/ggc_cusparse.cu, which calls
cusparseScsrcolor through graphColor(), color.hpp:19-88).

The port calls no vendor colouring: like the JAX driver it runs
`gc(..., algo="cusparse")`, which `gc` maps to the IS colouring (the
reference's own gcIS, gc.hpp:43-148, expresses csrcolor's Luby/Jones-
Plassmann scheme in GraphBLAS operations). `python -m
graphblast_tpu_torch.examples.ggc_cusparse <graph> [flags]`.
"""
import sys

from ._driver import run_driver
from .ggc import verify_and_count


def main(argv=None) -> int:
    from ..algorithms import gc

    def run(A, args, desc):
        return gc(A, seed=args.seed, max_colors=args.maxcolors, desc=desc,
                  algo="cusparse").dense

    return run_driver("ggc_cusparse", "IS graph coloring (vendor-baseline "
                      "parity driver)", run, lambda A, args: True,
                      lambda A, got, want: verify_and_count(A, got),
                      argv=argv)


if __name__ == "__main__":
    sys.exit(main())
