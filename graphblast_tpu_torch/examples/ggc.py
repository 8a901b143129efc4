"""Graph-colouring driver (counterpart of examples/ggc.py; reference:
example/ggc.cu and ggc_cusparse.cu). `python -m
graphblast_tpu_torch.examples.ggc <graph> [--gcalgo is|mis|jp|cusparse]
[--maxcolors K] [flags]`; it checks the colours with verify_gc and prints
how many it used."""
import sys

from ._driver import run_driver


def verify_and_count(A, got) -> bool:
    """verify_gc, and the GC[CORRECT]: colors=N line of the JAX driver."""
    import numpy as np

    from ..algorithms import verify_gc

    ok = verify_gc(A, got)
    print(f"GC[{'CORRECT' if ok else 'INCORRECT'}]: "
          f"colors={int(np.max(got)) if len(got) else 0}")
    return ok


def main(argv=None) -> int:
    from ..algorithms import gc

    def run(A, args, desc):
        return gc(A, seed=args.seed, max_colors=args.maxcolors, desc=desc,
                  algo=args.gcalgo).dense

    return run_driver("ggc", "graph coloring", run, lambda A, args: True,
                      lambda A, got, want: verify_and_count(A, got),
                      argv=argv)


if __name__ == "__main__":
    sys.exit(main())
