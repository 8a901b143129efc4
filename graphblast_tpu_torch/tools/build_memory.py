"""The card's memory by step of a Matrix build, and of pull-only BFS over
the Matrix: reads rmat(scale, edge_factor, seed)'s canonical COO from the
RMAT cache (`gen_rmat_cache` writes it; below CACHE_MIN_SCALE the graph is
generated here), builds the Matrix on the card through `Matrix.from_coo`
with a `utils.profiling.MemorySteps` recorder, builds the CSC's row
schedule and bitmap plan (`plan_for_bitmap`), and runs pull-only BFS from
`--source` `--runs` times.

    GRB_RMAT_CACHE_DIR=d python -m graphblast_tpu_torch.tools.build_memory \\
        24 --seed 0

Prints the card's name, one line a step (the most allocated above the
build's start, in bytes and bytes an edge, and seconds) and last one JSON
object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load(scale: int, edge_factor: int, seed: int):
    from ..io.mmio import canonicalize_coo
    from ..io.rmat import CACHE_MIN_SCALE, cache_path, load_coo, rmat_edges

    path = cache_path(scale, edge_factor, seed)
    if os.path.exists(path):
        return load_coo(path)
    if scale >= CACHE_MIN_SCALE:
        raise SystemExit(f"no cache file {path}: run python -m "
                         "graphblast_tpu_torch.tools.gen_rmat_cache "
                         f"{scale} --seed {seed} with the same "
                         "GRB_RMAT_CACHE_DIR first")
    rows, cols = rmat_edges(scale, edge_factor, seed)
    return canonicalize_coo(rows, cols, np.ones(len(rows), np.float32),
                            undirected=True, remove_self_loops=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scale", type=int)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    import graphblast_tpu_torch as gt
    from ..algorithms import bfs
    from ..ops.kernels.bitmap_pull import plan_for_bitmap
    from ..utils.profiling import MemorySteps

    if not torch.cuda.is_available():
        raise SystemExit("build_memory measures the card: no card here")
    print(f"[build] card {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    rows, cols, vals = _load(args.scale, args.edgefactor, args.seed)
    n, nnz = 1 << args.scale, len(rows)
    label = f"[build] rmat{args.scale}"
    print(f"{label}: n={n} nnz={nnz}, COO on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = dict(scale=args.scale, seed=args.seed, n=n, nnz=nnz)
    rec = MemorySteps()
    A = gt.Matrix.from_coo(rows, cols, vals, n, n, device="cuda", steps=rec)
    build_steps = [name for name, _, _ in rec.rows]
    plan_for_bitmap(A, transpose=True)
    rec("schedule and plan")
    desc = gt.BFS_TUNED.replace(mxv_mode=gt.Direction.PULLONLY)
    for _ in range(args.runs):
        levels = bfs(A, args.source, desc).dense
    reached = int((levels > 0).sum())
    rec("bfs runs")
    print("\n".join(rec.lines(label, nnz)), flush=True)
    out.update(steps=[list(r) for r in rec.rows], reached=reached,
               build_peak=rec.peak(build_steps), peak=rec.peak())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
