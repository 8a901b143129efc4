"""MatrixMarket ingest check at scale: a generated RMAT graph (seed 42) is
written as a pattern `.mtx` through `io.mmio.write_mtx`, then read back
directed by both parsers, the native C++ one (graphblast_tpu_torch/native)
and the NumPy one (GRB_NATIVE=0), whose canonical COO arrays must be equal.
Prints the file's size, each step's seconds and rate, and the parity line;
exits 1 on any difference.

    python -m graphblast_tpu_torch.tools.mtx_ingest_check [--scale 20]
        [--edgefactor 16] [--out PATH] [--skip-python] [--keep]

Without --out the file goes to a temporary directory; --skip-python times
the native parser only (the NumPy parse of 10^8 lines takes minutes).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from .. import native
from ..io import mmio
from ..io.rmat import rmat_edges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-python", action="store_true")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)

    n = 1 << args.scale
    tmp = None
    if args.out is None:
        tmp = tempfile.mkdtemp()
        path = os.path.join(tmp, f"rmat{args.scale}_{args.edgefactor}.mtx")
    else:
        path = args.out

    t0 = time.perf_counter()
    rows, cols = rmat_edges(args.scale, args.edgefactor, seed=42)
    print(f"[gen] rmat{args.scale} ef{args.edgefactor}: {len(rows):,} raw "
          f"edges in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mmio.write_mtx(path, rows, cols, None, n, n, field="pattern")
    t_write = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"[write] {path}: {size / 1e9:.2f} GB in {t_write:.1f} s "
          f"({size / t_write / 1e6:.0f} MB/s)")
    del rows, cols

    rc = 0
    try:
        t0 = time.perf_counter()
        nat = native.read_mtx_native(path, directed=1,
                                     remove_self_loops=True)
        t_nat = time.perf_counter() - t0
        if nat is None:
            print("[native] the native path is off (GRB_NATIVE=0)",
                  file=sys.stderr)
            return 2
        nr, nc, nv, nnr, nnc = nat
        print(f"[native] parsed and canonicalized {len(nr):,} edges in "
              f"{t_nat:.1f} s ({size / t_nat / 1e6:.0f} MB/s)")
        if not args.skip_python:
            before = os.environ.get("GRB_NATIVE")
            os.environ["GRB_NATIVE"] = "0"
            try:
                t0 = time.perf_counter()
                pr, pc, pv, pnr, pnc, _ = mmio.read_mtx(path, directed=1)
                t_py = time.perf_counter() - t0
            finally:
                if before is None:
                    os.environ.pop("GRB_NATIVE", None)
                else:
                    os.environ["GRB_NATIVE"] = before
            print(f"[python] parsed and canonicalized {len(pr):,} edges in "
                  f"{t_py:.1f} s (native speedup {t_py / t_nat:.1f}x)")
            ok = (len(pr) == len(nr) and (pnr, pnc) == (nnr, nnc)
                  and np.array_equal(pr, nr) and np.array_equal(pc, nc)
                  and np.array_equal(pv, nv))
            print(f"[parity] native == python: {'OK' if ok else 'MISMATCH'}")
            rc = 0 if ok else 1
    finally:
        if not args.keep:
            os.remove(path)
            if tmp is not None:
                os.rmdir(tmp)
    return rc


if __name__ == "__main__":
    sys.exit(main())
