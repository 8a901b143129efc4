"""Distributed algorithms over a 1D mesh: BFS, SSSP, CC, PageRank, LGC and
the BFS pseudo-diameter (counterpart of graphblast_tpu/parallel/
algorithms.py).

Every rank runs the same loop over its own blocks (parallel/partition.py)
and exchanges vectors through the collectives of parallel/ops.py. The JAX
package runs each fused loop as one lax.while_loop with its convergence
psum inside; here the all-reduced scalar is read on the host once an
iteration, as the port's single-device loops do (ROADMAP "Differences").
Two execution shapes, as in the JAX package:
  * fused pull loops (`make_*_dist`): BFS's pull on K1, SSSP's MinimumPlus
    pull on S, CC's MinimumSelectSecond pull on S, PageRank's Plus-Times
    pull on the value-pull kernel, LGC's Plus pull (its gathers on K6);
  * the stepped direction-optimized BFS (`bfs_dist(mode="auto")`): each
    iteration the host picks push or pull from the global frontier
    density, the reference's convert() heuristic (vector.hpp:292-323)
    lifted to the mesh.
Every entry returns the whole result as a host np.ndarray[:n] on every
rank, as the JAX entries return the gathered array. The fused dual-
direction BFS, the ring and 2D PageRank, TC, MIS and colouring wait for
ROADMAP item 10b and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..descriptor import BFS_TUNED, DEFAULT, Descriptor
from ..matrix import Matrix
from ..ops.elementwise import reduce_matrix_rows
from ..ops.gather_dispatch import take
from ..semiring import (LogicalOrAndSemiring, MinimumPlusSemiring,
                        MinimumSelectSecondSemiring, PlusMonoid,
                        PlusMultipliesSemiring)
from ..types import round_up
from . import ops as dops
from .bootstrap import AXIS
from .partition import ShardedMatrix, partition

MAXF = float(torch.finfo(torch.float32).max)
IMAX = int(torch.iinfo(torch.int32).max)

# the iterations of the last run of each loop on this rank (one pull, one
# K1, S or value-pull launch, each), and for the stepped BFS its pull
# iterations; read by the chip check
last_run: dict = {}

_10B = ("{} is not ported yet: it waits for ROADMAP item 10b (the sparse "
        "exchange, the ring and 2D layouts, TC, MIS and colouring of the "
        "distributed layer)")


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(_10B.format(name))

    stub.__name__ = name
    stub.__doc__ = f"Waits for ROADMAP item 10b; raises NotImplementedError."
    return stub


tc_dist = _not_ported("tc_dist")
tc_prepare = _not_ported("tc_prepare")
mis_dist = _not_ported("mis_dist")
make_mis_dist = _not_ported("make_mis_dist")
gc_dist = _not_ported("gc_dist")
make_gc_dist = _not_ported("make_gc_dist")
make_pr_ring_dist = _not_ported("make_pr_ring_dist")
make_pr_2d_dist = _not_ported("make_pr_2d_dist")


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


def make_bfs_dist(mesh, Ash: ShardedMatrix, desc: Descriptor = BFS_TUNED,
                  dual: bool = False, pair_cap: Optional[int] = None):
    """The fused pull-only distributed BFS: fn(source) -> this rank's
    block of the levels. dual=True, the traced push/pull switch with the
    sparse exchange, waits for item 10b."""
    if dual:
        raise NotImplementedError(_10B.format("make_bfs_dist(dual=True)"))
    group = _group(mesh, Ash)
    struconly = desc.structure_only

    def run(source: int) -> torch.Tensor:
        v, f = _bfs_start(Ash, source)
        it, succ = 1, 1
        while succ > 0 and it <= desc.max_niter:
            v = torch.where(f != 0, float(it), v)
            f = _bfs_pull(Ash, group, f, v, struconly)
            succ = int(dops.count(f != 0, group))   # the host read
            it += 1
        last_run["bfs"] = {"iterations": it - 1, "pull_iterations": it - 1}
        return v

    return run


def bfs_dist(A: Matrix, source: int, mesh, desc: Descriptor = BFS_TUNED,
             mode: str = "auto",
             Ash: Optional[ShardedMatrix] = None) -> np.ndarray:
    """Distributed BFS levels (1 at the source, 0 unreached), float32.
    mode: 'pull' = the fused pull loop; 'auto' = stepped push/pull, the
    host choosing the direction each iteration from the global frontier
    density (push while it is at most desc.switchpoint, unless
    desc.mxv_mode is PULLONLY); 'dual' waits for item 10b."""
    if mode == "dual":
        raise NotImplementedError(_10B.format("bfs_dist(mode='dual')"))
    if mode not in ("pull", "auto"):
        raise ValueError(f"mode must be 'pull', 'auto' or 'dual', not "
                         f"{mode!r}")
    if Ash is None:
        Ash = partition(A, mesh)
    group = _group(mesh, Ash)
    if mode == "pull":
        run = _cached_fn(Ash, ("bfs", desc),
                         lambda: make_bfs_dist(mesh, Ash, desc))
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
    n = Ash.n
    real = Ash.gids < n
    plan = Ash.value_pull_plan

    def run() -> torch.Tensor:
        p = torch.where(real, 1.0 / n, 0.0).to(torch.float32)
        it, err = 1, 1.0
        while err > eps and it <= desc.max_niter:
            p_swap = dops.dist_value_pull(plan, p, group)
            p_new = torch.where(real, p_swap + (1.0 - alpha) / n, 0.0)
            r = p_new - p
            err = float(torch.sqrt(dops.all_reduce(
                (r * r).sum().reshape(1), group=group)))   # the host read
            p = p_new
            it += 1
        last_run["pr"] = {"iterations": it - 1}
        return p

    return run


def pr_dist(A: Matrix, mesh, alpha: float = 0.85, eps: float = 1e-6,
            desc: Descriptor = DEFAULT, Ash: Optional[ShardedMatrix] = None,
            prepared: bool = False, comm: str = "allgather") -> np.ndarray:
    """Distributed PageRank, float32. comm='allgather' assembles the whole
    vector each iteration (one collective); 'ring' and '2d' wait for item
    10b. Without Ash, A is prepared (unless `prepared`) and partitioned;
    a caller's Ash is a partition of the prepared matrix."""
    if comm in ("ring", "2d"):
        raise NotImplementedError(_10B.format(f"pr_dist(comm={comm!r})"))
    if comm != "allgather":
        raise ValueError(f"comm must be 'allgather', 'ring' or '2d', not "
                         f"{comm!r}")
    if Ash is None:
        if not prepared:
            from ..algorithms.pr import prepare_pr_matrix

            A = prepare_pr_matrix(A, alpha)
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
            dops.all_reduce(contrib, torch.distributed.ReduceOp.MIN, group)
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
