"""Maximal-independent-set driver (counterpart of examples/gmis.py;
reference: example/gmis.cu). `python -m graphblast_tpu_torch.examples.gmis
<graph> [flags]`; it checks the set with verify_mis."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import mis, verify_mis

    def run(A, args, desc):
        return mis(A, seed=args.seed, desc=desc, mode=args.mode).dense

    def ver(A, got, want):
        ok = verify_mis(A, got)
        print("MIS:", "CORRECT" if ok else "INCORRECT")
        return ok

    return run_driver("gmis", "maximal independent set (Luby)", run,
                      lambda A, args: True, ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
