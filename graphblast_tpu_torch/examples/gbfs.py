"""BFS driver (counterpart of examples/gbfs.py; reference:
example/gbfs.cu). `python -m graphblast_tpu_torch.examples.gbfs <graph>
[flags]`."""
import sys

from ._driver import run_driver


def main(argv=None) -> int:
    from ..algorithms import bfs, reference
    from ..utils import verify_list

    def run(A, args, desc):
        return bfs(A, args.source, desc=desc, mode=args.mode).dense

    def cpu(A, args):
        return reference.bfs_cpu(A, args.source)

    def ver(A, got, want):
        return verify_list(got, want, "BFS")

    return run_driver("gbfs", "direction-optimized BFS", run, cpu, ver,
                      argv=argv)


if __name__ == "__main__":
    sys.exit(main())
