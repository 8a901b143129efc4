"""Connected-components driver (counterpart of examples/gcc.py; reference:
example/gcc.cu). `python -m graphblast_tpu_torch.examples.gcc <graph>
[flags]`; it checks the labels with verify_cc (gcc.cu's verifyCc) and has
no exact golden."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import cc, verify_cc

    def run(A, args, desc):
        return cc(A, seed=args.seed, desc=desc, mode=args.mode).dense

    def ver(A, got, want):
        ok = verify_cc(A, got)
        print("CC:", "CORRECT" if ok else "INCORRECT")
        return ok

    return run_driver("gcc", "connected components (FastSV)", run,
                      lambda A, args: True, ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
