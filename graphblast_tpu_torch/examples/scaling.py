"""Multi-rank scaling harness: edges/s at P = 1, 2, 4, 8 ranks (counterpart
of examples/scaling.py).

    python -m graphblast_tpu_torch.examples.scaling [--scale 13]
        [--edgefactor 16] [--algo bfs|pr|sssp|cc|tc|mis|gc|lgc]
        [--niter 3]
        [--device cuda|cpu] [--max_procs P]

It runs P NCCL ranks on the attached cards for each P, one a card, up to
torch.cuda.device_count(), through `parallel.bootstrap.launch`, and raises
without a card. --device cpu runs P gloo ranks on this machine's CPU
instead, up to 8 (the JAX harness re-execs into an 8-way virtual CPU mesh
for the same), which checks the collective paths and shows the harness's
own overhead curve. Each rank generates the RMAT
graph (seed 42) and partitions it (tc: tril(A), and tc_prepare's mask
edges); the source is the vertex of highest degree. A row is `P, ms/run,
Medges/s, efficiency_vs_P1`, ms/run the slowest rank's mean over --niter
runs after a warm-up run, Medges/s over A's edge count.
"""
import argparse
import sys
import time

ALGOS = ("bfs", "pr", "sssp", "cc", "tc", "mis", "gc", "lgc")


def _rank_run(mesh, scale: int, edgefactor: int, algo: str,
              niter: int) -> tuple:
    """One rank's part: (mean s a run, n, nnz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..algorithms.pr import prepare_pr_matrix
    from ..io.rmat import rmat_matrix
    from ..operations import tril
    from ..parallel import (bfs_dist, cc_dist, gc_dist, lgc_dist, mis_dist,
                            partition, pr_dist, sssp_dist, tc_dist,
                            tc_prepare)

    A = rmat_matrix(scale, edgefactor, seed=42, device="cpu")
    src = int(np.argmax(np.diff(A.host_csr()[0])))
    if algo == "tc":
        L = tril(A)
        prep = tc_prepare(L, mesh)
    else:
        Ash = partition(prepare_pr_matrix(A, 0.85) if algo == "pr" else A,
                        mesh)
    run = {"bfs": lambda: bfs_dist(A, src, mesh, mode="pull", Ash=Ash),
           "pr": lambda: pr_dist(A, mesh, Ash=Ash),
           "sssp": lambda: sssp_dist(A, src, mesh, Ash=Ash),
           "cc": lambda: cc_dist(A, mesh, Ash=Ash),
           "tc": lambda: tc_dist(L, mesh, prep=prep),
           "mis": lambda: mis_dist(A, mesh, Ash=Ash),
           "gc": lambda: gc_dist(A, mesh, Ash=Ash),
           "lgc": lambda: lgc_dist(A, src, mesh, Ash=Ash)}[algo]
    run()    # warm: kernels, schedules and plans built
    dist.barrier(group=mesh.get_group())
    t0 = time.perf_counter()
    for _ in range(niter):
        run()       # each run ends in an all-gather read on the host
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / niter, A.nrows, A.nvals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--algo", choices=ALGOS, default="bfs")
    ap.add_argument("--niter", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="NCCL ranks on the attached cards (default), or "
                         "gloo ranks on the CPU")
    ap.add_argument("--max_procs", type=int, default=None,
                    help="the largest P (default the card count, 8 with "
                         "--device cpu)")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import launch

    device_type = args.device
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaling.py runs on cuda unless --device cpu asks "
                           "for the CPU, and torch.cuda.is_available() is "
                           "False")
    ndev = torch.cuda.device_count() if device_type == "cuda" else 8
    top = min(args.max_procs or ndev, ndev)
    base = None
    for P in (1, 2, 4, 8):
        if P > top:
            break
        rows = launch(_rank_run, P, args.scale, args.edgefactor, args.algo,
                      args.niter, device_type=device_type)
        dt = max(r[0] for r in rows)
        n, nnz = rows[0][1], rows[0][2]
        if base is None:
            print(f"algo={args.algo} n={n} nnz={nnz} devices={ndev}")
            print("P, ms/run, Medges/s, efficiency_vs_P1")
        meps = nnz / dt / 1e6
        if base is None:
            base = meps
        print(f"{P}, {dt * 1e3:.1f}, {meps:.1f}, "
              f"{meps / (base * P) * 100:.0f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
