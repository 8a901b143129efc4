"""CLI flag parser mirroring the reference driver flags (counterpart of
graphblast_tpu/utils/cli.py).

Re-expression of parseArgs' ~30 boost::program_options flags
(reference: util.hpp:39-132) + Descriptor::loadArgs
(backend/cuda/descriptor.hpp:207-287) as argparse. Flag names and defaults
match the reference so run_*.sh-style sweeps port directly; --device
(default cuda) is this package's own.
"""
from __future__ import annotations

import argparse

from ..descriptor import Descriptor
from ..types import Direction


def build_parser(prog: str, description: str = "") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("mtx", help="MatrixMarket graph file (or rmat:<scale>[:<edgefactor>])")
    # general params (util.hpp:58-75)
    p.add_argument("--niter", type=int, default=5, help="benchmark repetitions")
    p.add_argument("--max_niter", type=int, default=10000, help="max algorithm iterations")
    p.add_argument("--directed", type=int, default=0, choices=[0, 1, 2],
                   help="0: honor mtx symmetry, 1: force directed, 2: force undirected")
    p.add_argument("--timing", type=int, default=0, choices=[0, 1, 2],
                   help="per-iteration CSV rows")
    p.add_argument("--transpose", action="store_true", help="run on Aᵀ")
    p.add_argument("--mtxinfo", action="store_true", help="print mtx banner info")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--skip_cpu_verify", action="store_true",
                   help="skip golden verification (large graphs)")
    # traversal params (util.hpp:76-90)
    p.add_argument("--source", type=int, default=0)
    p.add_argument("--source_start", type=int, default=0)
    p.add_argument("--source_end", type=int, default=1)
    p.add_argument("--mxvmode", type=int, default=0, choices=[0, 1, 2],
                   help="0: push-pull auto, 1: push only, 2: pull only")
    p.add_argument("--switchpoint", type=float, default=0.01,
                   help="push/pull frontier-density threshold")
    p.add_argument("--dirinfo", action="store_true")
    p.add_argument("--struconly", type=int, default=0,
                   help="structure-only (boolean) semiring mode")
    p.add_argument("--opreuse", type=int, default=0)
    # push params (util.hpp:91-103)
    p.add_argument("--memusage", type=float, default=1.0,
                   help="push workspace = memusage * nnz")
    p.add_argument("--endbit", type=int, default=1)
    p.add_argument("--sort", type=int, default=1,
                   help="1: sort-based push (MERGE), 0: scatter push (SIMPLE)")
    p.add_argument("--atomic", type=int, default=0)
    # pull params (util.hpp:104-110)
    p.add_argument("--earlyexit", type=int, default=0)
    p.add_argument("--fusedmask", type=int, default=1)
    # algorithm params (util.hpp:111-121)
    p.add_argument("--maxcolors", type=int, default=128)
    p.add_argument("--gcalgo", type=str, default="is",
                   choices=["is", "mis", "jp", "cusparse"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.85)
    p.add_argument("--eps", type=float, default=1e-6)
    # system params (util.hpp:122-132)
    p.add_argument("--ta", type=int, default=0,
                   help="(accepted; reference mxm thread knob)")
    p.add_argument("--tb", type=int, default=0,
                   help="(accepted; reference mxm thread knob)")
    p.add_argument("--split", type=int, default=0,
                   help="(accepted; reference sort-workspace reuse knob)")
    p.add_argument("--fixedrow", type=int, default=0,
                   help="(accepted; reference test-harness knob)")
    p.add_argument("--ccalgo", type=str, default="fastsv", choices=["fastsv"],
                   help="connected-components algorithm (reference also "
                        "supports only the FastSV family)")
    p.add_argument("--nthread", type=int, default=0,
                   help="(accepted; reference OpenMP knob)")
    p.add_argument("--ndevice", type=int, default=0,
                   help="shard across N devices (0 = single device)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--memory", action="store_true")
    p.add_argument("--profile", type=str, default="",
                   help="capture a torch.profiler trace into this directory "
                        "(reference: cudaProfilerStart hooks, gbfs.cu:98)")
    p.add_argument("--mode", type=str, default="fused",
                   choices=["fused", "stepped"],
                   help="fused: the loop without per-iteration output; "
                        "stepped: per-iter CSV")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the graph and the run live on "
                        "(cpu runs the kernels' plain versions)")
    return p


_MXV_MODES = {0: Direction.PUSHPULL, 1: Direction.PUSHONLY, 2: Direction.PULLONLY}


def descriptor_from_args(args) -> Descriptor:
    """loadArgs equivalent (reference: backend/cuda/descriptor.hpp:207-287)."""
    return Descriptor(
        structure_only=bool(args.struconly),
        mxv_mode=_MXV_MODES[args.mxvmode],
        switchpoint=args.switchpoint,
        memusage=args.memusage,
        earlyexit=bool(args.earlyexit),
        opreuse=bool(args.opreuse),
        endbit=bool(args.endbit),
        sort_push=bool(args.sort),
        fusedmask=bool(args.fusedmask),
        max_niter=args.max_niter,
        timing=args.timing,
        debug=args.debug,
        dirinfo=args.dirinfo,
        seed=args.seed,
    )


def load_graph(args, dtype=None):
    """readMtx + build on args.device, honoring --directed/--transpose; also
    accepts rmat:<scale>[:<edgefactor>[:<seed>]] pseudo-paths for generated
    inputs (the seed defaults to --seed)."""
    import torch

    from ..io.rmat import rmat_matrix
    from ..matrix import Matrix

    dtype = dtype or torch.float32
    if args.mtx.startswith("rmat:"):
        parts = args.mtx.split(":")[1:]
        scale = int(parts[0])
        ef = int(parts[1]) if len(parts) > 1 else 16
        seed = int(parts[2]) if len(parts) > 2 else args.seed
        A = rmat_matrix(scale, ef, seed, undirected=args.directed != 1,
                        dtype=dtype, device=args.device)
    else:
        A = Matrix.from_mtx(args.mtx, directed=args.directed, dtype=dtype,
                            device=args.device)
    if args.transpose:
        from ..operations import transpose

        A = transpose(A)
    if args.mtxinfo:
        print(A)
    return A
