"""The benchmark's command: one run of one cell on the NVIDIA card.

    python3 -m gbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers compared, each beside its
limit, as the last lines of standard error, and the result as the last line
of standard output: one JSON object with correct, attempted, failed,
metrics, device, breakdown (traced runs) and checks. Exits non-zero, with
no result, where there is no card, where the run loaded JAX or the JAX
package, or where anything it needs is missing.
"""
import time

T0 = time.perf_counter()   # set-up starts here, before torch loads

import argparse   # noqa: E402
import json   # noqa: E402
import os   # noqa: E402
import sys   # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gbench import harness

    # the program's caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(harness.ROOT, ".cache", "triton"))
    import torch

    bench = harness.load_bench()
    cell, _, _ = harness.resolve(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"gbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              "the benchmark runs on no other device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", bench=bench,
                           t0=T0)
    found = harness.devinfo.forbidden_loaded()
    if found:
        print(f"gbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"gbench: each call's ms {out.pop('latencies_ms')}", file=sys.stderr)
    print(f"gbench: set-up spans (s) and the graph "
          f"{json.dumps(out.pop('spans'))}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
