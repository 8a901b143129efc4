"""Local-graph-clustering driver (counterpart of examples/glgc.py;
reference: example/glgc.cu). `python -m graphblast_tpu_torch.examples.glgc
<graph> [flags]`; --alpha defaults to 0.15 here."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import lgc, reference
    from ..utils import verify_list_float

    def run(A, args, desc):
        return lgc(A, args.source, alpha=args.alpha, eps=args.eps,
                   desc=desc).dense

    def cpu(A, args):
        return reference.lgc_cpu(A, args.source, alpha=args.alpha,
                                 eps=args.eps, max_niter=args.max_niter)

    def ver(A, got, want):
        return verify_list_float(got, want, "LGC")

    # the shared parser's --alpha is PageRank's 0.85: a later --alpha in
    # the caller's arguments overrides this 0.15
    argv = ["--alpha", "0.15", *(sys.argv[1:] if argv is None else argv)]
    return run_driver("glgc", "local graph clustering (PPR push)", run, cpu,
                      ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
