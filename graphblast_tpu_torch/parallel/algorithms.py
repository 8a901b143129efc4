"""Distributed algorithms over a 1D mesh, and PageRank over the ring and
2D layouts: BFS, SSSP, CC, PageRank, LGC, TC, MIS, IS colouring and the
BFS pseudo-diameter (counterpart of graphblast_tpu/parallel/
algorithms.py).

Every rank runs the same loop over its own blocks (parallel/partition.py,
ring.py, partition2d.py) and exchanges vectors through the collectives of
parallel/ops.py. The JAX package runs each fused loop as one
lax.while_loop with its convergence psum inside; here the all-reduced
scalar is read on the host once an iteration, as the port's single-device
loops do (ROADMAP "Differences"). The execution shapes:
  * fused pull loops (`make_*_dist`): BFS's pull on K1, SSSP's MinimumPlus
    pull on S, CC's MinimumSelectSecond pull on S, PageRank's Plus-Times
    pull on the value-pull kernel (its ring and 2D pulls through
    spmv_pull, K6), LGC's Plus pull (its gathers on K6), MIS's and
    colouring's MaximumMultiplies pull on S;
  * the fused direction-optimized BFS (`make_bfs_dist(dual=True)`,
    `bfs_dist(mode="dual")`): each iteration pushes through the sparse
    owner-bucketed exchange or pulls on K1, by the JAX loop's rule, on
    values all-reduced and read on the host;
  * the stepped direction-optimized BFS (`bfs_dist(mode="auto")`): each
    iteration the host picks push or pull from the global frontier
    density, the reference's convert() heuristic (vector.hpp:292-323)
    lifted to the mesh, and pushes through the dense partial;
  * the ring-staged TC (`tc_dist`): CSR row blocks rotate around the
    ring, and each stage is one launch of T1.
Every entry returns the whole result as a host np.ndarray[:n] on every
rank (tc_dist a Python int), as the JAX entries return the gathered
array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..descriptor import BFS_TUNED, DEFAULT, Descriptor
from ..matrix import Matrix
from ..operations import transpose
from ..ops.elementwise import reduce_matrix_rows
from ..ops.gather_dispatch import take
from ..ops.spmspv import frontier_degrees
from ..semiring import (LogicalOrAndSemiring, MaximumMultipliesSemiring,
                        MinimumPlusSemiring, MinimumSelectSecondSemiring,
                        PlusMonoid, PlusMultipliesSemiring)
from ..types import round_up
from . import ops as dops
from .bootstrap import AXIS
from .partition import ShardedMatrix, partition
from .partition2d import (_pull_block, all_reduce_2d, gather_2d,
                          partition_2d)
from .ring import _peer, partition_ring, ring_mxv_pull

MAXF = float(torch.finfo(torch.float32).max)
IMAX = int(torch.iinfo(torch.int32).max)

# the iterations of the last run of each loop on this rank (one pull, one
# K1, S or value-pull launch, each), and for the stepped BFS its pull
# iterations; read by the chip check
last_run: dict = {}

def _group(mesh, Ash: ShardedMatrix):
    """The mesh's process group, after checking that Ash is this rank's
    block of a partition over it."""
    if mesh.size() != Ash.P or mesh.get_local_rank(AXIS) != Ash.rank:
        raise ValueError(f"Ash holds block {Ash.rank} of {Ash.P}; this rank "
                         f"is {mesh.get_local_rank(AXIS)} of {mesh.size()}")
    return mesh.get_group(AXIS)


def _shard_edge_cap(Ash: ShardedMatrix, desc: Descriptor) -> int:
    cap = int(Ash.csr_ind.shape[0] * min(desc.memusage, 1.0))
    return max(round_up(max(cap, 128), 128), 128)


def _cached_fn(Ash: ShardedMatrix, key, build):
    """The loop closure `build()` makes for Ash, made once per key and
    kept on Ash, so that repeat calls reuse its plans and schedules."""
    cache = Ash._cache.setdefault("fn", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _gathered(block: torch.Tensor, group, n: int) -> np.ndarray:
    return dops.all_gather(block, group)[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------


def _bfs_pull(Ash: ShardedMatrix, group, f, v, struconly: bool):
    """One masked pull of the frontier: the structure-only pull on K1 over
    the block's plan, a pull of values through spmv_pull."""
    if struconly:
        return dops.dist_or_pull_bitmap(Ash.pull_plan, f, mask_block=v,
                                        mask_scmp=True, group=group)
    ptr, ind, val = Ash.csc()
    return dops.dist_vxm_pull(ptr, ind, val, f, LogicalOrAndSemiring,
                              Ash.rows_per, mask_block=v, mask_scmp=True,
                              structure_only=struconly, group=group)


def _bfs_start(Ash: ShardedMatrix, source: int):
    v = torch.zeros(Ash.rows_per, dtype=torch.float32, device=Ash.device)
    return v, (Ash.gids == source).to(torch.float32)


def _pair_cap(Ash: ShardedMatrix, edge_cap: int,
              pair_cap: Optional[int]) -> int:
    """The sparse push's block of pairs a destination rank: by default
    edge_cap / P rounded up to 256 lanes (at least 256), and never more
    than edge_cap (a tiny block's edge_cap is below the 256 floor)."""
    if pair_cap is None:
        pair_cap = max(round_up(max(edge_cap // max(Ash.P, 1), 256), 256),
                       256)
    return min(pair_cap, edge_cap)


def _frontier_state(Ash: ShardedMatrix, group, f):
    """(f_ind, f_val, f_nv, state): this rank's frontier compacted, and
    the all-reduced (frontier count, the most frontier edges of any rank)
    as one int32 (2,) tensor, to be read on the host once."""
    f_ind, f_val, f_nv = dops.local_frontier(f, 0.0)
    deg = frontier_degrees(Ash.csr_ptr, f_ind, f_nv).sum(dtype=torch.int32)
    cnt = dops.count(f != 0, group)
    deg = dops.all_reduce(deg.reshape(1), dist.ReduceOp.MAX, group)
    return f_ind, f_val, f_nv, torch.cat([cnt, deg])


def make_bfs_dist(mesh, Ash: ShardedMatrix, desc: Descriptor = BFS_TUNED,
                  dual: bool = False, pair_cap: Optional[int] = None):
    """The fused distributed BFS: fn(source) -> this rank's block of the
    levels. The default loop pulls every iteration (K1 when
    desc.structure_only). dual=True is the fused direction-optimized
    loop: iteration `it` pushes through the sparse exchange
    (ops.dist_vxm_push_sparse, K6) when the frontier's density succ /
    n_pad is at most desc.switchpoint and the push is feasible, the most
    frontier edges of any rank being at most edge_cap; else it pulls.
    There is no PULLONLY check, as in the JAX loop. The frontier's count
    and edge maximum come in one host read an iteration, computed at the
    end of the iteration before (and once before the first); a push reads
    its overflow predicate once more."""
    group = _group(mesh, Ash)
    struconly = desc.structure_only
    if not dual:
        def run(source: int) -> torch.Tensor:
            v, f = _bfs_start(Ash, source)
            it, succ = 1, 1
            while succ > 0 and it <= desc.max_niter:
                v = torch.where(f != 0, float(it), v)
                f = _bfs_pull(Ash, group, f, v, struconly)
                succ = int(dops.count(f != 0, group))   # the host read
                it += 1
            last_run["bfs"] = {"iterations": it - 1,
                               "pull_iterations": it - 1}
            return v

        return run

    edge_cap = _shard_edge_cap(Ash, desc)
    pcap = _pair_cap(Ash, edge_cap, pair_cap)

    def run_dual(source: int) -> torch.Tensor:
        v, f = _bfs_start(Ash, source)
        f_ind, f_val, f_nv, state = _frontier_state(Ash, group, f)
        succ, deg_max = state.tolist()                  # the host read
        it, reads, directions = 1, 1, []
        while succ > 0 and it <= desc.max_niter:
            v = torch.where(f != 0, float(it), v)
            use_push = (succ / Ash.n_pad <= desc.switchpoint
                        and deg_max <= edge_cap)
            if use_push:
                f = dops.dist_vxm_push_sparse(
                    *Ash.csr(), f_ind, None if struconly else f_val, f_nv,
                    LogicalOrAndSemiring, Ash.P, Ash.rows_per, edge_cap,
                    pcap, mask_block=v, mask_scmp=True,
                    structure_only=struconly, group=group)
                reads += 1                  # the overflow predicate
            else:
                f = _bfs_pull(Ash, group, f, v, struconly)
            directions.append((succ, deg_max, "push" if use_push
                               else "pull"))
            f_ind, f_val, f_nv, state = _frontier_state(Ash, group, f)
            succ, deg_max = state.tolist()              # the host read
            reads += 1
            it += 1
        last_run["bfs"] = {
            "iterations": it - 1,
            "pull_iterations": sum(d[2] == "pull" for d in directions),
            "directions": directions, "host_reads": reads,
            "edge_cap": edge_cap, "pair_cap": pcap}
        return v

    return run_dual


def bfs_dist(A: Matrix, source: int, mesh, desc: Descriptor = BFS_TUNED,
             mode: str = "auto",
             Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed BFS levels (1 at the source, 0 unreached), float32.
    mode: 'pull' = the fused pull loop; 'dual' = the fused
    direction-optimized loop with the sparse push exchange
    (make_bfs_dist(dual=True)); 'auto' = stepped push/pull, the host
    choosing the direction each iteration from the global frontier
    density (push while it is at most desc.switchpoint, unless
    desc.mxv_mode is PULLONLY)."""
    if mode not in ("pull", "auto", "dual"):
        raise ValueError(f"mode must be 'pull', 'auto' or 'dual', not "
                         f"{mode!r}")
    if Ash is None:
        Ash = partition(A, mesh)
    group = _group(mesh, Ash)
    if mode in ("pull", "dual"):
        run = _cached_fn(Ash, ("bfs", mode, desc),
                         lambda: make_bfs_dist(mesh, Ash, desc,
                                               dual=mode == "dual"))
        return _gathered(run(source), group, Ash.n)

    edge_cap = _shard_edge_cap(Ash, desc)
    struconly = desc.structure_only
    v, f = _bfs_start(Ash, source)
    succ, pulls, it = 1, 0, 0
    for it in range(1, desc.max_niter + 1):
        use_push = (desc.mxv_mode.name != "PULLONLY"
                    and succ / Ash.n <= desc.switchpoint)
        v = torch.where(f != 0, float(it), v)
        if use_push:
            f_ind, f_val, f_nv = dops.local_frontier(f, 0.0)
            f = dops.dist_vxm_push(
                *Ash.csr(), f_ind, f_val, f_nv, LogicalOrAndSemiring, Ash.P,
                Ash.rows_per, edge_cap, mask_block=v, mask_scmp=True,
                structure_only=struconly, group=group)
        else:
            f = _bfs_pull(Ash, group, f, v, struconly)
            pulls += 1
        succ = int(dops.count(f != 0, group))       # the host read
        if desc.timing >= 1:
            print(f"{it}, {succ}/{Ash.n}, -, "
                  f"{'push' if use_push else 'pull'}, -")
        if succ == 0:
            break
    last_run["bfs"] = {"iterations": it, "pull_iterations": pulls}
    return _gathered(v, group, Ash.n)


def diameter_dist(A: Matrix, s_start: int, s_end: int, mesh,
                  desc: Descriptor = BFS_TUNED,
                  Ash: Optional[ShardedMatrix] = None):
    """Distributed pseudo-diameter: (the largest eccentricity over sources
    [s_start, s_end), its first source), by bfs_dist sweeps (the default
    'auto') over one partition; (0, -1) when no source reaches another."""
    if Ash is None:
        Ash = partition(A, mesh)
    best, best_s = 0, -1
    for s in range(s_start, s_end):
        ecc = int(bfs_dist(A, s, mesh, desc=desc, Ash=Ash).max()) - 1
        if ecc > best:
            best, best_s = ecc, s
    return best, best_s


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------


def make_pr_dist(mesh, Ash: ShardedMatrix, alpha: float = 0.85,
                 eps: float = 1e-6, desc: Descriptor = DEFAULT):
    """The fused distributed PageRank over a partition of the prepared
    (α/outdegree-scaled) matrix: fn() -> this rank's block of p. Its pull
    runs on the value-pull kernel over the block's plan (on the CPU its
    plain version)."""
    group = _group(mesh, Ash)
    real = Ash.gids < Ash.n
    plan = Ash.value_pull_plan

    def run() -> torch.Tensor:
        return _pr_loop(lambda p: dops.dist_value_pull(plan, p, group),
                        real, Ash.n, alpha, eps, desc.max_niter,
                        lambda t: dops.all_reduce(t, group=group), "pr")

    return run


def _pr_loop(step, real: torch.Tensor, n: int, alpha: float, eps: float,
             max_niter: int, reduce_sum, key: str) -> torch.Tensor:
    """The PageRank iteration over this rank's vertex block: p_swap =
    step(p), the pull of p over the prepared matrix's transpose; the
    error's square sum all-reduced by reduce_sum and read on the host."""
    p = torch.where(real, 1.0 / n, 0.0).to(torch.float32)
    it, err = 1, 1.0
    while err > eps and it <= max_niter:
        p_new = torch.where(real, step(p) + (1.0 - alpha) / n, 0.0)
        r = p_new - p
        err = float(torch.sqrt(reduce_sum((r * r).sum().reshape(1))))
        p = p_new
        it += 1
    last_run[key] = {"iterations": it - 1}
    return p


def make_pr_ring_dist(mesh, Rsh, alpha: float = 0.85, eps: float = 1e-6,
                      desc: Descriptor = DEFAULT):
    """The ring-scheduled distributed PageRank over a RingShardedMatrix of
    Aᵀ (partition_ring(transpose(A_prepared), mesh)): fn() -> this rank's
    block of p. Each iteration is one ring pull (ring.ring_mxv_pull, P
    stages, each stage's Plus pull gathering on K6)."""
    group = mesh.get_group(AXIS)
    real = Rsh.rank * Rsh.rows_per + torch.arange(
        Rsh.rows_per, device=Rsh.device) < Rsh.n

    def run() -> torch.Tensor:
        return _pr_loop(
            lambda p: ring_mxv_pull(Rsh, p, PlusMultipliesSemiring,
                                    group=group),
            real, Rsh.n, alpha, eps, desc.max_niter,
            lambda t: dops.all_reduce(t, group=group), "pr_ring")

    return run


def make_pr_2d_dist(mesh2, Ash2, alpha: float = 0.85, eps: float = 1e-6,
                    desc: Descriptor = DEFAULT):
    """The 2D-partitioned distributed PageRank over a Sharded2D of Aᵀ
    (partition_2d(transpose(A_prepared), mesh2), mesh2 an (R, C) mesh with
    axes ("r", "c")): fn() -> this rank's segment of p, segment i·C + j
    of the vector. Each iteration is one 2D pull (partition2d._pull_block:
    the all-gathers over "c" and "r", the block's Plus pull on K6, an
    all-reduce over "c")."""
    real = Ash2.flat_rank * Ash2.seg + torch.arange(
        Ash2.seg, device=Ash2.device) < Ash2.n

    def run() -> torch.Tensor:
        return _pr_loop(
            lambda p: _pull_block(Ash2, p, PlusMultipliesSemiring, mesh2),
            real, Ash2.n, alpha, eps, desc.max_niter,
            lambda t: all_reduce_2d(t, dist.ReduceOp.SUM,
                                    mesh2), "pr_2d")

    return run


def pr_dist(A: Matrix, mesh, alpha: float = 0.85, eps: float = 1e-6,
            desc: Descriptor = DEFAULT, Ash: Optional[ShardedMatrix] = None,
            prepared: bool = False, comm: str = "allgather") -> np.ndarray:
    """Distributed PageRank, float32. comm: 'allgather' assembles the
    whole vector each iteration (one collective) and pulls on the value
    pull; 'ring' streams 1/P segments around the ring of ranks, the
    transfer of one overlapping the pull of another; '2d' runs the block
    layout over an (R, C) `mesh` with axes ("r", "c"), each rank's
    exchange bounded to its mesh row and column. The ring and 2D paths
    prepare (unless `prepared`), transpose and partition A on every call,
    as the JAX package does, and ignore Ash. Without Ash, the allgather
    path prepares and partitions A; a caller's Ash is a partition of the
    prepared matrix."""
    if comm not in ("allgather", "ring", "2d"):
        raise ValueError(f"comm must be 'allgather', 'ring' or '2d', not "
                         f"{comm!r}")
    if comm in ("ring", "2d") or Ash is None:
        if not prepared:
            from ..algorithms.pr import prepare_pr_matrix

            A = prepare_pr_matrix(A, alpha)
    if comm == "ring":
        Rsh = partition_ring(transpose(A), mesh)
        p = make_pr_ring_dist(mesh, Rsh, alpha, eps, desc)()
        return _gathered(p, mesh.get_group(AXIS), Rsh.n)
    if comm == "2d":
        Ash2 = partition_2d(transpose(A), mesh)
        p = make_pr_2d_dist(mesh, Ash2, alpha, eps, desc)()
        return gather_2d(p, mesh)[:Ash2.n].cpu().numpy()
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("pr", alpha, eps, desc.max_niter),
                     lambda: make_pr_dist(mesh, Ash, alpha, eps, desc))
    return _gathered(run(), _group(mesh, Ash), Ash.n)


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------


def make_sssp_dist(mesh, Ash: ShardedMatrix, desc: Descriptor = DEFAULT):
    """The fused distributed Bellman-Ford: fn(source) -> this rank's block
    of the distances (FLT_MAX unreached). Each iteration pulls MinimumPlus
    over the column block on S."""
    group = _group(mesh, Ash)

    def run(source: int) -> torch.Tensor:
        ptr, ind, val = Ash.csc()
        sched = Ash.schedule(True)
        v = torch.where(Ash.gids == source, 0.0, MAXF).to(torch.float32)
        f = v
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            y = dops.dist_vxm_pull(ptr, ind, val, f, MinimumPlusSemiring,
                                   Ash.rows_per, group=group, sched=sched)
            f = torch.where(y < v, y, MAXF)
            v = torch.minimum(v, y)
            succ = int(dops.count(f != MAXF, group))    # the host read
            it += 1
        last_run["sssp"] = {"iterations": it - 1}
        return v

    return run


def sssp_dist(A: Matrix, source: int, mesh, desc: Descriptor = DEFAULT,
              Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed Bellman-Ford distances (the fused pull loop)."""
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("sssp", desc.max_niter),
                     lambda: make_sssp_dist(mesh, Ash, desc))
    return _gathered(run(source), _group(mesh, Ash), Ash.n)


# ---------------------------------------------------------------------------
# Connected components (FastSV)
# ---------------------------------------------------------------------------


def make_cc_dist(mesh, Ash: ShardedMatrix, desc: Descriptor = DEFAULT):
    """The fused distributed FastSV (single-device: algorithms/cc.py;
    reference cc.hpp:17-136): fn() -> this rank's block of the parents.
    The stochastic hook pulls MinimumSelectSecond over the row block on S;
    the min-hook parent[parent] ← mnp, a scatter across all ranks, is a
    local scatter_reduce("amin") into an n_pad vector and an all-reduce
    MIN; the grandparents gather the all-gathered parents (K6)."""
    group = _group(mesh, Ash)
    rows_per, n_pad = Ash.rows_per, Ash.n_pad
    base = Ash.rank * rows_per

    def run() -> torch.Tensor:
        ptr, ind, val = Ash.csr()
        sched = Ash.schedule(False)
        parent = Ash.gids.clone()
        mnp, gp, gp_t = parent, parent, parent
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            parent_temp = parent
            # 1) stochastic hooking: mnp_t[i] = min over A(i,:) of gp
            mnp_t = dops.dist_mxv_pull(ptr, ind, val, gp,
                                       MinimumSelectSecondSemiring, rows_per,
                                       group=group, sched=sched)
            mnp = torch.minimum(mnp, mnp_t)
            # min-hook parent[parent_temp] ← mnp across every rank
            contrib = torch.full((n_pad,), IMAX, dtype=torch.int32,
                                 device=Ash.device)
            contrib.scatter_reduce_(0, parent_temp.long(), mnp, "amin")
            dops.all_reduce(contrib, dist.ReduceOp.MIN, group)
            parent = torch.minimum(parent, contrib[base:base + rows_per])
            # 2) aggressive hooking, 3) shortcutting
            parent = torch.minimum(torch.minimum(parent, mnp), parent_temp)
            # 4) grandparents gp[u] = parent[parent[u]], a global gather
            parent_full = dops.all_gather(parent, group)
            gp_new = take(parent_full, parent.clamp(0, n_pad - 1))
            # 5) termination, 6) the unproductive filter
            diff = gp_t != gp_new
            succ_t = dops.count(diff, group)
            gp_t = gp_new
            gp = torch.where(diff, gp_new, IMAX)
            succ = int(succ_t)                          # the host read
            it += 1
        last_run["cc"] = {"iterations": it - 1}
        return parent

    return run


def cc_dist(A: Matrix, mesh, desc: Descriptor = DEFAULT,
            Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed connected components (the fused FastSV loop): int32
    labels, the least vertex id of each component on a symmetric graph."""
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("cc", desc.max_niter),
                     lambda: make_cc_dist(mesh, Ash, desc))
    return _gathered(run(), _group(mesh, Ash), Ash.n)


# ---------------------------------------------------------------------------
# Local graph clustering (ACL PPR push)
# ---------------------------------------------------------------------------


def make_lgc_dist(mesh, Ash: ShardedMatrix, alpha: float = 0.15,
                  eps: float = 1e-6, desc: Descriptor = DEFAULT):
    """The fused distributed ACL push (single-device: algorithms/lgc.py;
    reference lgc.hpp:14-163): fn(source) -> this rank's block of p. Its
    one collective a round is the all-gather of the Plus pull of r2 over
    the row block (K6 at the column ids and the row boundaries)."""
    group = _group(mesh, Ash)
    rows_per = Ash.rows_per

    def run(source: int) -> torch.Tensor:
        rp, ri, rv = Ash.csr()
        if ri.shape[0]:
            deg = reduce_matrix_rows(rp, rv, PlusMonoid, rows_per)
        else:
            deg = torch.zeros(rows_per, dtype=rv.dtype, device=Ash.device)
        p = torch.zeros(rows_per, dtype=torch.float32, device=Ash.device)
        r = torch.where(Ash.gids == source, 1.0, 0.0).to(torch.float32)
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            f = (r >= deg * eps) & (deg > 0)
            succ_t = dops.count(f, group)
            p = p + torch.where(f, alpha * r, 0.0)
            spread = torch.where(f, (1.0 - alpha) / 2.0 * r, 0.0)
            r2 = torch.where(f, spread / deg.clamp(min=1.0), 0.0)
            push = dops.dist_mxv_pull(rp, ri, rv, r2, PlusMultipliesSemiring,
                                      rows_per, group=group)
            r = torch.where(f, spread, r) + push
            succ = int(succ_t)                          # the host read
            it += 1
        last_run["lgc"] = {"iterations": it - 1}
        return p

    return run


def lgc_dist(A: Matrix, source: int, mesh, alpha: float = 0.15,
             eps: float = 1e-6, desc: Descriptor = DEFAULT,
             Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed local graph clustering (approximate PPR around
    `source`), float32."""
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("lgc", alpha, eps, desc.max_niter),
                     lambda: make_lgc_dist(mesh, Ash, alpha, eps, desc))
    return _gathered(run(source), _group(mesh, Ash), Ash.n)


# ---------------------------------------------------------------------------
# Triangle counting (ring-staged masked intersection)
# ---------------------------------------------------------------------------


def _tc_prepare(L: Matrix, P: int, rows_per: int, rank: int):
    """Host prep of rank `rank`'s mask edges: L's stored edges (i, j) with
    i in this rank's row block, bucketed by the row block b of j, with
    block-local ids. Returns (ei (P, mcap), ej (P, mcap), counts (P,), mcap,
    ec), row `rank` of the JAX package's (P, P, mcap) arrays and (P, P)
    counts; mcap (the most edges of any bucket, rounded up to 256) and ec
    (the most expansion lanes of any bucket, Σ deg(i), rounded up to 512)
    are over all P·P buckets, as there. ec sizes nothing here: T1 counts
    without expanding, in int64, so the JAX package's refusal of ec ≥ 2^24
    (a bound of its float32 stage sum) does not apply."""
    r, c, _ = L.extract_tuples()
    deg = np.diff(L.host_csr()[0].astype(np.int64))
    bucket = (r // rows_per) * P + c // rows_per
    counts = np.bincount(bucket, minlength=P * P).astype(np.int32)
    exp = np.bincount(bucket, weights=deg[r], minlength=P * P)
    mcap = max(round_up(max(int(counts.max()), 1), 256), 256)
    ec = max(round_up(max(int(exp.max()), 1), 512), 512)
    mine = bucket // P == rank
    order = np.argsort(bucket[mine], kind="stable")
    rs, cs = r[mine][order], c[mine][order]
    ei = np.zeros((P, mcap), np.int32)
    ej = np.zeros((P, mcap), np.int32)
    offs = np.concatenate([[0], np.cumsum(counts[rank * P:(rank + 1) * P])])
    for b in range(P):
        s, t = offs[b], offs[b + 1]
        ei[b, :t - s] = rs[s:t] - rank * rows_per
        ej[b, :t - s] = cs[s:t] - b * rows_per
    return ei, ej, counts.reshape(P, P)[rank], mcap, ec


@dataclasses.dataclass(eq=False)
class TCPrep:
    """What tc_dist reuses across calls (tc_prepare): this rank's
    partition of L, its mask edges by the block of j (on the rank's
    device), their counts, whether L's stored values are all 1, and the
    intersection schedule of each stage, built at its first launch on
    the card and kept (a stage's schedule depends on the prep alone)."""

    Ash: ShardedMatrix
    ei: torch.Tensor
    ej: torch.Tensor
    counts: list
    mcap: int
    ec: int
    unit: bool
    schedules: dict = dataclasses.field(default_factory=dict)

    def edges(self, b: int) -> tuple:
        """(mi, mj) of the mask edges whose j lies in row block b."""
        m = self.counts[b]
        return self.ei[b, :m], self.ej[b, :m]


def tc_prepare(L: Matrix, mesh, Ash: Optional[ShardedMatrix] = None
               ) -> TCPrep:
    """The host prep tc_dist reuses across calls: partitions L unless Ash
    (a partition of L over `mesh`) is given, and buckets this rank's mask
    edges."""
    if Ash is None:
        Ash = partition(L, mesh)
    _group(mesh, Ash)
    ei, ej, counts, mcap, ec = _tc_prepare(L, Ash.P, Ash.rows_per, Ash.rank)
    _, _, v = L.extract_tuples()
    dev = Ash.device
    return TCPrep(Ash=Ash, ei=torch.from_numpy(ei).to(dev),
                  ej=torch.from_numpy(ej).to(dev), counts=counts.tolist(),
                  mcap=mcap, ec=ec, unit=bool(np.all(v == 1)))


def _tc_stage(prep: TCPrep, b: int, held: tuple) -> int:
    """The triangles closed by this rank's mask edges into row block b,
    whose CSR (ptr, ind, val) is `held`: one T1 launch (one T2
    PlusMultiplies launch, its sum rounded, where L's values are not all
    1; the JAX stage sums av · bval over the matches and rounds)."""
    from ..ops.kernels.intersect_schedule import build_intersect_schedule
    from ..ops.kernels.masked_intersect import (masked_intersect_count,
                                                masked_intersect_fold)

    mi, mj = prep.edges(b)
    if mi.shape[0] == 0:
        return 0
    lptr, lind, lval = prep.Ash.csr()
    bptr, bind, bval = held
    sched = None
    if mi.device.type == "cuda":
        key = (b, prep.unit)
        if key not in prep.schedules:
            prep.schedules[key] = build_intersect_schedule(
                mi, mj, lptr, bptr, prep.Ash.n_pad, not prep.unit)
        sched = prep.schedules[key]
    if prep.unit:
        return masked_intersect_count(mi, mj, lptr, lind, bptr, bind,
                                      sched=sched)
    c = masked_intersect_fold(mi, mj, lptr, lind, lval, bptr, bind, bval,
                              PlusMultipliesSemiring, sched=sched)
    return int(torch.round(c.sum(dtype=torch.float64)))


def tc_dist(L: Matrix, mesh, Ash: Optional[ShardedMatrix] = None,
            prep: Optional[TCPrep] = None) -> int:
    """Distributed triangle count of lower-triangular L (single-device:
    algorithms/tc.py tc(); reference tc.hpp:15-54), an exact Python int on
    every rank. Ring-staged: at stage s rank k holds row block
    b = (k − s) mod P of L (its own at s = 0), intersects its mask edges
    into block b against it, and meanwhile sends the block to rank k+1 and
    receives block b−1 from rank k−1, so each rank holds O(E/P) of L at a
    time. The stage counts add up in int64 and are all-reduced."""
    if prep is None:
        prep = tc_prepare(L, mesh, Ash)
    Ash = prep.Ash
    group = _group(mesh, Ash)
    P, my = Ash.P, Ash.rank
    held = (Ash.csr_ptr, Ash.csr_ind, Ash.csr_val)
    total = 0
    for s in range(P):
        reqs = None
        if s < P - 1:
            nxt = tuple(torch.empty_like(t) for t in held)
            ops = []
            for t, u in zip(held, nxt):
                ops += [dist.P2POp(dist.isend, t, _peer(group, (my + 1) % P),
                                   group),
                        dist.P2POp(dist.irecv, u, _peer(group, (my - 1) % P),
                                   group)]
            reqs = dist.batch_isend_irecv(ops)
        total += _tc_stage(prep, (my - s) % P, held)
        if reqs is not None:
            for req in reqs:
                req.wait()
            held = nxt
    out = torch.tensor([total], dtype=torch.int64, device=Ash.device)
    last_run["tc"] = {"stages": P}
    return int(dops.all_reduce(out, group=group).item())


# ---------------------------------------------------------------------------
# MIS and IS colouring
# ---------------------------------------------------------------------------


def _shard_weights(seed: int, Ash: ShardedMatrix) -> torch.Tensor:
    """This rank's strictly positive random int32 weights in [1, 2^30),
    0 on the padding rows: drawn on the CPU from a torch.Generator seeded
    from (seed, rank), as the single-device mis.random_weights draws them
    (the JAX package folds the rank into a jax.random key)."""
    from ..algorithms.mis import random_weights

    w = random_weights(Ash.rows_per, (seed << 20) + Ash.rank, Ash.device)
    return torch.where(Ash.gids < Ash.n, w, 0)


def _weights_block(Ash: ShardedMatrix, seed: int, weights) -> torch.Tensor:
    if weights is None:
        return _shard_weights(seed, Ash)
    w = torch.as_tensor(np.asarray(weights) if not isinstance(
        weights, torch.Tensor) else weights)
    if w.shape != (Ash.rows_per,):
        raise ValueError(f"weights: a block of {Ash.rows_per}, not "
                         f"{tuple(w.shape)}")
    return w.to(device=Ash.device, dtype=torch.int32)


def _csc_int(Ash: ShardedMatrix) -> tuple:
    """The column block with int32 values, and its schedule (MIS's and
    colouring's pulls), made once and kept."""
    if "csc/int" not in Ash._cache:
        ptr, ind, val = Ash.csc()
        Ash._cache["csc/int"] = (ptr, ind, val.to(torch.int32),
                                 Ash.schedule(True))
    return Ash._cache["csc/int"]


def make_mis_dist(mesh, Ash: ShardedMatrix, seed: int = 0,
                  desc: Descriptor = DEFAULT, weights=None):
    """The distributed Luby MIS (single-device: algorithms/mis.py; the
    reference mis.hpp:23-141): fn() -> this rank's 0/1 int32 block of the
    membership. `weights`, this rank's (rows_per,) block of candidate
    weights (0 = not a candidate), replaces the seeded ones, as
    mis_inner(A, w0) takes them. A round: the MaximumMultiplies pull of w
    masked by w (S), f = w > m, then the LogicalOrAnd pull of f masked by
    w over the values (K6 at the row ids and at the boundaries)."""
    group = _group(mesh, Ash)
    rows_per = Ash.rows_per

    def run() -> torch.Tensor:
        cp, ci, cv, sched = _csc_int(Ash)
        w = _weights_block(Ash, seed, weights)
        v = torch.zeros(rows_per, dtype=torch.int32, device=Ash.device)
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            m = dops.dist_vxm_pull(cp, ci, cv, w, MaximumMultipliesSemiring,
                                   rows_per, mask_block=w, group=group,
                                   sched=sched)
            f = (w > m).to(torch.int32)
            v = torch.where(f != 0, 1, v)
            w = torch.where(f != 0, 0, w)
            succ_t = dops.count(f != 0, group)
            m2 = dops.dist_vxm_pull(cp, ci, cv, f, LogicalOrAndSemiring,
                                    rows_per, mask_block=w, group=group)
            w = torch.where(m2 != 0, 0, w)
            succ = int(succ_t)                          # the host read
            it += 1
        last_run["mis"] = {"iterations": it - 1}
        return v

    return run


def mis_dist(A: Matrix, mesh, seed: int = 0, desc: Descriptor = DEFAULT,
             Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed maximal independent set (0/1 int32 membership)."""
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("mis", seed, desc.max_niter),
                     lambda: make_mis_dist(mesh, Ash, seed, desc))
    return _gathered(run(), _group(mesh, Ash), Ash.n)


def make_gc_dist(mesh, Ash: ShardedMatrix, seed: int = 0,
                 desc: Descriptor = DEFAULT, weights=None):
    """The distributed IS colouring (single-device: algorithms/gc.py
    _gc_is_round; the reference gc.hpp:43-148): fn() -> this rank's int32
    block of colours, each the 1-based id of the Luby round that selects
    the vertex. `weights` as make_mis_dist's. A round is one unmasked
    MaximumMultiplies pull (S)."""
    group = _group(mesh, Ash)
    rows_per = Ash.rows_per

    def run() -> torch.Tensor:
        cp, ci, cv, sched = _csc_int(Ash)
        w = _weights_block(Ash, seed, weights)
        v = torch.zeros(rows_per, dtype=torch.int32, device=Ash.device)
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            m = dops.dist_vxm_pull(cp, ci, cv, w, MaximumMultipliesSemiring,
                                   rows_per, group=group, sched=sched)
            f = w > m
            succ_t = dops.count(f, group)
            v = torch.where(f, it, v)
            w = torch.where(f, 0, w)
            succ = int(succ_t)                          # the host read
            it += 1
        last_run["gc"] = {"iterations": it - 1}
        return v

    return run


def gc_dist(A: Matrix, mesh, seed: int = 0, desc: Descriptor = DEFAULT,
            Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed IS graph colouring (colours are 1-based round ids)."""
    if Ash is None:
        Ash = partition(A, mesh)
    run = _cached_fn(Ash, ("gc", seed, desc.max_niter),
                     lambda: make_gc_dist(mesh, Ash, seed, desc))
    return _gathered(run(), _group(mesh, Ash), Ash.n)
