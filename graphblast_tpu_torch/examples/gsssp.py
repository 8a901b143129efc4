"""SSSP driver (counterpart of examples/gsssp.py; reference:
example/gsssp.cu). `python -m graphblast_tpu_torch.examples.gsssp <graph>
[flags]`."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import reference, sssp
    from ..utils import verify_list_float

    def run(A, args, desc):
        return sssp(A, args.source, desc=desc, mode=args.mode).dense

    def cpu(A, args):
        return reference.sssp_cpu(A, args.source)

    def ver(A, got, want):
        return verify_list_float(got, want, "SSSP")

    return run_driver("gsssp", "Bellman-Ford SSSP", run, cpu, ver, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
