"""PageRank driver (counterpart of examples/gpr.py; reference:
example/gpr.cu, with its α/outdegree matrix prep at gpr.cu:82-98).
`python -m graphblast_tpu_torch.examples.gpr <graph> [flags]`; the golden
is pr_cpu at eps·1e-3, checked to 1e-2."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import pr, reference
    from ..utils import verify_list_float

    def run(A, args, desc):
        return pr(A, alpha=args.alpha, eps=args.eps, desc=desc,
                  mode=args.mode).dense

    def cpu(A, args):
        return reference.pr_cpu(A, alpha=args.alpha, eps=args.eps * 1e-3,
                                max_niter=args.max_niter)

    def ver(A, got, want):
        return verify_list_float(got, want, "PR", tol=1e-2)

    return run_driver("gpr", "PageRank", run, cpu, ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
