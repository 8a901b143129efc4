"""Shared example-driver machinery (counterpart of examples/_driver.py;
reference: example/gbfs.cu:22-124 flow):

    parseArgs → readMtx → build Matrix → CPU golden → warmup run →
    VERIFY vs golden → --niter benchmark loop → timing summary row

The summary row mirrors the reference's `cpu, warmup, tight` ms print
(gbfs.cu:110-115) plus GTEPS (stored edges over the tight time)."""
from __future__ import annotations

import time

import numpy as np
import torch


def _on_host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_driver(name, description, run_fn, cpu_fn, verify_fn,
               argv=None) -> int:
    """run_fn(A, args, desc) -> result (a tensor on A's device, or an array
    on the host); cpu_fn(A, args) -> golden; verify_fn(A, got, want) ->
    bool, with got on the host. `argv` is parsed in place of sys.argv.
    Returns 0 when the result verifies (or verification is skipped), 1
    when it does not."""
    from ..utils import cli
    from ..utils.profiling import trace

    args = cli.build_parser(name, description).parse_args(argv)
    desc = cli.descriptor_from_args(args)

    t0 = time.perf_counter()
    A = cli.load_graph(args)
    build_ms = (time.perf_counter() - t0) * 1000
    print(f"{name}: {args.mtx} n={A.nrows} nnz={A.nvals} "
          f"build={build_ms:.1f}ms device={A.device}")
    build_peak = None
    if args.memory and A.device.type == "cuda":
        # the build's peak, told apart from the runs' below
        build_peak = torch.cuda.max_memory_allocated(A.device)
        print(f"build memory: {build_peak} B the most allocated, "
              f"{build_peak / max(A.nvals, 1):.2f} B an edge")
        torch.cuda.reset_peak_memory_stats(A.device)

    # CPU golden (reference: gbfs.cu:74-76 bfsCpu)
    want = None
    cpu_ms = 0.0
    if not args.skip_cpu_verify and cpu_fn is not None:
        t0 = time.perf_counter()
        want = cpu_fn(A, args)
        cpu_ms = (time.perf_counter() - t0) * 1000

    # warmup run (the first one builds kernels and plans), gbfs.cu:80-88
    t0 = time.perf_counter()
    got = run_fn(A, args, desc)
    _synchronize(A.device)
    warmup_ms = (time.perf_counter() - t0) * 1000

    ok = True
    if want is not None:
        ok = verify_fn(A, _on_host(got), want)

    # benchmark loop, gbfs.cu:102-115 (optionally under a profiler trace,
    # the cudaProfilerStart/Stop analog, gbfs.cu:98,106)
    with trace(args.profile):
        t0 = time.perf_counter()
        for _ in range(args.niter):
            got = run_fn(A, args, desc)
        _synchronize(A.device)
        tight_ms = (time.perf_counter() - t0) * 1000 / max(args.niter, 1)

    eps = A.nvals / (tight_ms * 1e-3) if tight_ms > 0 else float("inf")
    print("cpu, warmup, tight, GTEPS")
    print(f"{cpu_ms:.3f}, {warmup_ms:.3f}, {tight_ms:.3f}, {eps / 1e9:.4f}")
    if build_peak is not None:
        # the reference's memory_ flag: the card's memory after the runs
        # (cudaMemGetInfo, backend/cuda/util.hpp:26-33)
        free, total = torch.cuda.mem_get_info(A.device)
        runs_peak = torch.cuda.max_memory_allocated(A.device)
        print(f"runs memory: {runs_peak} B the most allocated after the "
              "build")
        print(f"memory: {total - free} B used of {total} B on the card, "
              f"{max(build_peak, runs_peak)} B the most allocated")
    return 0 if ok else 1
