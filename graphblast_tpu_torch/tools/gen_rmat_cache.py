"""Build the canonicalized RMAT cache files that `io.rmat.rmat_matrix`
reads from scale 20 on (edge factor 16, seed 42, as the benchmarks use), on
the host with NumPy and the native canonicalize, with no Matrix build and
no device: so that a run at RMAT 22 or 24 spends no time generating its
graph.

    python -m graphblast_tpu_torch.tools.gen_rmat_cache 22 24

The files go to GRB_RMAT_CACHE_DIR, default `.cache/` at the repository
root (gitignored); an existing file is left as it is. `rmat_matrix` looks in
the temporary directory unless GRB_RMAT_CACHE_DIR is set, so give the run
that reads the files the same GRB_RMAT_CACHE_DIR. Prints the raw and
canonical edge counts, the seconds of each step and the peak host memory.
"""
from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np

from ..io.mmio import canonicalize_coo
from ..io.rmat import cache_path, rmat_edges, save_coo

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, os.pardir, ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scales", type=int, nargs="+")
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    cache = os.path.normpath(os.environ.get("GRB_RMAT_CACHE_DIR",
                                            DEFAULT_DIR))
    os.makedirs(cache, exist_ok=True)
    for scale in args.scales:
        cpath = cache_path(scale, args.edgefactor, args.seed, cache)
        if os.path.exists(cpath):
            print(f"[gen] {cpath} exists: skipped", flush=True)
            continue
        t0 = time.perf_counter()
        rows, cols = rmat_edges(scale, args.edgefactor, args.seed)
        t1 = time.perf_counter()
        print(f"[gen] rmat{scale}: {len(rows):,} raw edges in "
              f"{t1 - t0:.1f} s", flush=True)
        vals = np.ones(len(rows), dtype=np.float32)
        rows, cols, vals = canonicalize_coo(rows, cols, vals, undirected=True,
                                            remove_self_loops=True)
        t2 = time.perf_counter()
        print(f"[gen] canonicalized to {len(rows):,} edges in "
              f"{t2 - t1:.1f} s", flush=True)
        save_coo(cpath, rows, cols, vals)
        print(f"[gen] wrote {cpath} ({os.path.getsize(cpath) / 1e9:.2f} GB, "
              f"{time.perf_counter() - t2:.1f} s)", flush=True)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    print(f"[gen] peak host memory {peak / 2**20:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
