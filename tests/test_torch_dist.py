"""The port's distributed layer (`graphblast_tpu_torch.parallel`) on 4 gloo
ranks on the CPU, held against the JAX package's on its virtual mesh of
the same 4 devices (`jax.make_mesh((4,), ("x",))`, of the conftest's 8;
`jax.make_mesh((2, 2), ("r", "c"))` for the 2D layout, which the ranks
build as `init_device_mesh("cpu", (2, 2), mesh_dim_names=("r", "c"))`).

One spawn for the whole module: `_rank_cases` runs every distributed case
on each of the 4 ranks (parallel.bootstrap.launch, a file:// store under a
temporary directory, so parallel test workers never share a port) and
returns its results, which the tests below read. The JAX side runs in this
process with the JAX package's own GRB_DIST_PALLAS=0, so that its pulls
take their plain jnp route (the Pallas plans give the same results, which
the JAX package's own tests hold, at many times the CPU time in interpret
mode).

Tolerances: the partition arrays (1D, ring, 2D, TC's buckets), BFS levels
and directions, CC labels, the diameter, the triangle counts, MIS and
colouring, the LogicalOr and Min pushes and pulls are exact; SSSP within
1e-4, PageRank within 1e-5, the Plus push within 1e-5 relative, the ring
and 2D Plus pulls within 1e-5·max|y| and LGC
within rtol 1e-4 / atol 1e-7 (the JAX test_lgc_dist_matches_single_chip
bar) of JAX's.
"""
import os

import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu_torch import parallel as par
from graphblast_tpu_torch.io.rmat import rmat_matrix
from graphblast_tpu_torch.parallel.partition import LEAVES, ShardedMatrix

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
P = 4
GRAPHS = ("chesapeake", "rmat10")
PR_EPS, LGC_EPS = 1e-7, 1e-5
MIS_SEED = 1
PUSH_SEMIRINGS = ("LogicalOrAnd", "MinimumPlus", "PlusMultiplies")
# the dual BFS's descriptors: the tuned one, switchpoint 1 (push wherever
# feasible), the pull of values, and a push workspace too small for the
# hub's frontier (memusage 0.05), so feasibility turns pushes into pulls
DUAL = {"dual": {}, "dual_sp1": {"switchpoint": 1.0},
        "dual_tight": {"switchpoint": 1.0, "memusage": 0.05}}
DUAL_VALUES = {"structure_only": False, "switchpoint": 1.0}
# the sparse push's bucket cap past which a rank's frontier overflows
TINY_PAIR_CAP = 8


def _port_graph(name: str):
    if name == "chesapeake":
        return tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                                   use_cache=False, device="cpu")
    return rmat_matrix(10, 8, seed=3, device="cpu")


def _hub(ptr) -> int:
    return int(np.argmax(np.diff(np.asarray(ptr))))


def _push_frontier(n_pad: int) -> np.ndarray:
    """A seeded frontier over the padded vertices: about a fifth of them,
    each with a value in [1, 2)."""
    rng = np.random.default_rng(15)
    f = np.where(rng.random(n_pad) < 0.2, 1.0 + rng.random(n_pad), 0.0)
    return f.astype(np.float32)


def _mxv_x(n: int, semiring: str) -> np.ndarray:
    """The ring and 2D pulls' seeded x: 0/1 for LogicalOrAnd, else values
    in [0, 4)."""
    rng = np.random.default_rng(16)
    if semiring == "LogicalOrAnd":
        return (rng.random(n) < 0.3).astype(np.float32)
    return (4 * rng.random(n)).astype(np.float32)


def _non_unit(L):
    """(rows, cols, values) of L's entries with values 1 + (i + j) mod 3,
    float32: a lower triangle whose values are not all 1."""
    r, c, _ = L.extract_tuples()
    r, c = np.asarray(r), np.asarray(c)
    return r, c, (1 + (r + c) % 3).astype(np.float32)


def _sparse_push_cases(Ash, group, rank: int) -> dict:
    """The sparse push on this rank's block of `_push_frontier`, gathered:
    under each push semiring, with the default pair_cap, with a tiny one
    (the overflow path) and the dense push; and owner_buckets' counts for
    the first 3, the first 12 and all vertices as the frontier."""
    from graphblast_tpu_torch.parallel.algorithms import _pair_cap
    from graphblast_tpu_torch.parallel.ops import (
        dist_vxm_push, dist_vxm_push_sparse, local_frontier, owner_buckets)

    rows_per, n_pad = Ash.rows_per, Ash.n_pad
    edge_cap = Ash.csr_ind.shape[0]
    lo = rank * rows_per
    fb = torch.from_numpy(_push_frontier(n_pad)[lo:lo + rows_per])
    f_ind, f_val, f_nv = local_frontier(fb, 0.0)
    out = {"pair_cap": _pair_cap(Ash, edge_cap, None)}
    for name in PUSH_SEMIRINGS:
        semiring = getattr(tgb, name + "Semiring")
        so = name == "LogicalOrAnd"
        args = (*Ash.csr(), f_ind, None if so else f_val, f_nv, semiring,
                P, rows_per, edge_cap)
        for tag, cap in (("sparse", out["pair_cap"]),
                         ("overflow", TINY_PAIR_CAP)):
            w = dist_vxm_push_sparse(*args, cap, structure_only=so,
                                     group=group)
            out[name, tag] = par.ops.all_gather(w, group).numpy()
        w = dist_vxm_push(*args, structure_only=so, group=group)
        out[name, "dense"] = par.ops.all_gather(w, group).numpy()
    _, _, _, (_, counts) = owner_buckets(
        *Ash.csr(), f_ind, None, f_nv, tgb.LogicalOrAndSemiring, P,
        rows_per, edge_cap, True, torch.float32)
    out["frontier_counts"] = counts.numpy()
    out["counts"] = []
    for fsize in (3, 12, Ash.n):
        f = np.zeros(n_pad, np.float32)
        f[:fsize] = 1.0
        fi, _, fn = local_frontier(torch.from_numpy(f[lo:lo + rows_per]),
                                   0.0)
        _, _, _, (_, counts) = owner_buckets(
            *Ash.csr(), fi, None, fn, tgb.LogicalOrAndSemiring, P, rows_per,
            edge_cap, True, torch.float32)
        out["counts"].append(counts.numpy())
    return out


def _near_end_case(group, rank: int) -> dict:
    """The sparse push where the last bucket starts within pair_cap of the
    end of the sorted lanes (ported from the JAX test at P = 4): rows_per
    8, edge_cap 64, pair_cap 32; rank 0's rows 0 and 1 expand to 64
    pairs, 20 into each of blocks 0-2 (none past pair_cap) and the last
    4, into block 3, starting at lane 60, so a window of 32 there reaches
    past the 64 lanes. Rank 0's CSR is built by hand (it repeats ids,
    which the structure-only push takes). Returns the sparse and dense
    results, gathered, and the reachable columns."""
    from graphblast_tpu_torch.parallel.ops import (
        dist_vxm_push, dist_vxm_push_sparse, local_frontier)

    rows_per, edge_cap, pair_cap = 8, 64, 32
    cols = ([8 * b + e % 8 for b in range(3) for e in range(20)]
            + [24, 25, 26, 27])
    ptr = np.zeros(rows_per + 1, np.int32)
    ind = np.zeros(0, np.int32)
    f = np.zeros(rows_per, np.float32)
    if rank == 0:
        ptr[1:] = 64
        ptr[1] = 60
        ind = np.asarray(cols, np.int32)
        f[[0, 1]] = 1.0
    f_ind, _, f_nv = local_frontier(torch.from_numpy(f), 0.0)
    args = (torch.from_numpy(ptr), torch.from_numpy(ind),
            torch.ones(len(ind)), f_ind, None, f_nv,
            tgb.LogicalOrAndSemiring, P, rows_per, edge_cap)
    sparse = dist_vxm_push_sparse(*args, pair_cap, structure_only=True,
                                  group=group)
    dense = dist_vxm_push(*args, structure_only=True, group=group)
    want = np.zeros(P * rows_per, bool)
    want[np.unique(cols)] = True
    return {"sparse": par.ops.all_gather(sparse, group).numpy(),
            "dense": par.ops.all_gather(dense, group).numpy(),
            "want": want}


def _rank_second_half(mesh, mesh2, A, Ash, src: int, weights: dict,
              cache_dir: str) -> dict:
    """This rank's cases of the second half of the layer on one graph."""
    import graphblast_tpu_torch.parallel.algorithms as palg
    from graphblast_tpu_torch.parallel.partition import _content_fingerprint

    group = mesh.get_group("x")
    rank = mesh.get_local_rank("x")
    r = {"push": _sparse_push_cases(Ash, group, rank)}
    for tag, kw in DUAL.items():
        r[tag] = par.bfs_dist(A, src, mesh, tgb.BFS_TUNED.replace(**kw),
                              mode="dual", Ash=Ash)
        r[tag + "_run"] = dict(palg.last_run["bfs"])
    r["dual_values"] = par.bfs_dist(A, src, mesh,
                                    tgb.DEFAULT.replace(**DUAL_VALUES),
                                    mode="dual", Ash=Ash)
    run = par.make_bfs_dist(mesh, Ash, tgb.BFS_TUNED.replace(
        switchpoint=1.0), dual=True, pair_cap=TINY_PAIR_CAP)
    r["dual_tiny_pair_cap"] = par.ops.all_gather(run(src), group)[
        :Ash.n].numpy()
    r["dual_tiny_run"] = dict(palg.last_run["bfs"])
    # the ring and the 2D layout
    Rsh = par.partition_ring(A, mesh)
    r["ring_arrays"] = Rsh.to_numpy()
    A2 = par.partition_2d(A, mesh2)
    r["2d_arrays"] = A2.to_numpy()
    r["2d_coords"] = (A2.i, A2.j)
    for name in PUSH_SEMIRINGS:
        semiring = getattr(tgb, name + "Semiring")
        x = _mxv_x(A.nrows, name)
        r["ring", name] = par.mxv_ring(A, mesh, x, semiring, Rsh=Rsh)
        r["2d", name] = par.mxv_2d(A2, mesh2, x, semiring)
        if name == "LogicalOrAnd":
            r["ring", "struct"] = par.mxv_ring(A, mesh, x, semiring,
                                               Rsh=Rsh, structure_only=True)
            r["2d", "struct"] = par.mxv_2d(A2, mesh2, x, semiring,
                                           structure_only=True)
    r["pr_ring"] = par.pr_dist(A, mesh, alpha=0.85, eps=PR_EPS, comm="ring")
    r["pr_2d"] = par.pr_dist(A, mesh2, alpha=0.85, eps=PR_EPS, comm="2d")
    # TC, over the unit lower triangle and one with other values
    L = tgb.tril(A)
    prep = par.tc_prepare(L, mesh)
    r["tc_prep"] = (prep.ei.numpy(), prep.ej.numpy(), list(prep.counts),
                    prep.mcap, prep.ec, prep.unit)
    r["tc"] = par.tc_dist(L, mesh, prep=prep)
    r["tc_again"] = par.tc_dist(L, mesh, prep=prep)
    r["tc_own"] = par.tc_dist(L, mesh)
    rr, cc, vv = _non_unit(L)
    L2 = tgb.Matrix.from_coo(rr, cc, vv, A.nrows, A.ncols, device="cpu")
    prep2 = par.tc_prepare(L2, mesh)
    r["tc_non_unit"] = (par.tc_dist(L2, mesh, prep=prep2), prep2.unit)
    # MIS and colouring, with JAX's weights and with their own
    w = weights[rank]
    r["mis_jax_w"] = par.ops.all_gather(par.make_mis_dist(
        mesh, Ash, weights=w)(), group)[:Ash.n].numpy()
    r["gc_jax_w"] = par.ops.all_gather(par.make_gc_dist(
        mesh, Ash, weights=w)(), group)[:Ash.n].numpy()
    r["mis"] = par.mis_dist(A, mesh, seed=MIS_SEED, Ash=Ash)
    r["gc"] = par.gc_dist(A, mesh, seed=MIS_SEED, Ash=Ash)
    # the partition cache: build and save, load, a changed value, and a
    # directory that does not exist (saving raises OSError there)
    base = os.path.join(cache_dir, "graph.mtx")
    path = par.shard_cache_path(base, P, rank)
    built = par.partition_cached(A, mesh, base)
    saved = os.path.exists(path)
    loaded = par.partition_cached(A, mesh, base)
    rows, cols, vals = A.extract_tuples()
    vals = np.asarray(vals).copy()
    vals[0] += 1
    B = tgb.Matrix.from_coo(np.asarray(rows), np.asarray(cols), vals,
                            A.nrows, A.ncols, device="cpu")
    rebuilt = par.partition_cached(B, mesh, base)
    nowhere = os.path.join(cache_dir, "missing", "graph.mtx")
    unsaved = par.partition_cached(A, mesh, nowhere)
    r["cache"] = {
        "path": path, "saved": saved, "built": built.to_numpy(),
        "loaded": loaded.to_numpy(), "rebuilt": rebuilt.to_numpy(),
        "fresh_B": par.partition(B, mesh).to_numpy(),
        "unsaved": unsaved.to_numpy(),
        "nowhere_written": os.path.exists(os.path.dirname(nowhere)),
        "fingerprints": (_content_fingerprint(A), _content_fingerprint(B))}
    return r


def _rank_cases(mesh, jax_arrays: dict, mis_weights: dict,
                cache_dir: str) -> dict:
    """Every distributed case on this rank; runs in each spawned rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from graphblast_tpu_torch.algorithms.pr import prepare_pr_matrix
    from graphblast_tpu_torch.parallel.ops import (_combine_partials,
                                                   dist_reduce)

    group = mesh.get_group("x")
    rank = mesh.get_local_rank("x")
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("r", "c"))
    out = {"near_end": _near_end_case(group, rank)}
    for g in GRAPHS:
        A = _port_graph(g)
        src = _hub(A.host_csr()[0])
        Ash = par.partition(A, mesh)
        r = out[g] = {"arrays": Ash.to_numpy(), "src": src}
        r["plans_before"] = sorted(k for k in Ash._cache if "plan" in k)
        r["bfs_pull"] = par.bfs_dist(A, src, mesh, mode="pull", Ash=Ash)
        plan = Ash.pull_plan
        r["bfs_pull_again"] = par.bfs_dist(A, src, mesh, mode="pull",
                                           Ash=Ash)
        r["plan_kept"] = (Ash.pull_plan is plan
                          and plan.sched is Ash.schedule(True))
        r["bfs_auto"] = par.bfs_dist(A, src, mesh, mode="auto", Ash=Ash)
        r["bfs_auto_pulls"] = par.algorithms.last_run["bfs"][
            "pull_iterations"]
        r["bfs_push"] = par.bfs_dist(
            A, src, mesh, desc=tgb.BFS_TUNED.replace(switchpoint=1.0),
            Ash=Ash)
        r["bfs_push_pulls"] = par.algorithms.last_run["bfs"][
            "pull_iterations"]
        r["bfs_pullonly_auto"] = par.bfs_dist(
            A, src, mesh, desc=tgb.BFS_TUNED.replace(
                mxv_mode=tgb.Direction.PULLONLY, switchpoint=1.0), Ash=Ash)
        r["bfs_values"] = par.bfs_dist(A, src, mesh, desc=tgb.DEFAULT,
                                       mode="pull", Ash=Ash)
        r["sssp"] = par.sssp_dist(A, src, mesh)
        r["cc"] = par.cc_dist(A, mesh)
        r["pr"] = par.pr_dist(A, mesh, alpha=0.85, eps=PR_EPS)
        Apr = par.partition(prepare_pr_matrix(A, 0.85), mesh)
        r["pr_given"] = par.pr_dist(A, mesh, alpha=0.85, eps=PR_EPS,
                                    Ash=Apr)
        r["value_plan_kept"] = (Apr.value_pull_plan.sched
                                is Apr.schedule(True))
        r["lgc"] = par.lgc_dist(A, src, mesh, alpha=0.15, eps=LGC_EPS)
        r["diameter"] = par.diameter_dist(A, 0, 4, mesh, Ash=Ash)
        arrays, n, nvals = jax_arrays[g]
        J = ShardedMatrix.from_jax_arrays(arrays, rank, n=n, nvals=nvals,
                                          device="cpu")
        r["from_jax"] = J.to_numpy()
        r["from_jax_bfs"] = par.bfs_dist(None, src, mesh, mode="pull",
                                         Ash=J)
        r["own_partition_bfs"] = par.bfs_dist(A, src, mesh, mode="pull")
        cache = os.path.join(cache_dir, g)
        if rank == 0:
            os.makedirs(cache)
        torch.distributed.barrier(group)
        r.update(_rank_second_half(mesh, mesh2, A, Ash, src, mis_weights[g],
                                   cache))

    rows_per = 32
    rng = np.random.default_rng(100 + rank)
    partials = {"PlusMultiplies": rng.random(P * rows_per),
                "LogicalOrAnd": rng.random(P * rows_per) < 0.2,
                "MinimumPlus": rng.random(P * rows_per) * 10}
    out["combine"] = {}
    for name, partial in partials.items():
        t = torch.from_numpy(partial.astype(np.float32))
        semiring = getattr(tgb, name + "Semiring")
        out["combine"][name] = (partial.astype(np.float32), _combine_partials(
            t, semiring, P, rows_per, group).numpy())
    x = torch.from_numpy(rng.random(rows_per).astype(np.float32) - 0.5)
    out["reduce"] = {m: (x.numpy(), float(dist_reduce(x, getattr(tgb, m),
                                                      group)))
                     for m in ("PlusMonoid", "MinimumMonoid", "MaximumMonoid",
                               "MultipliesMonoid")}
    out["shard"] = par.shard_vector(mesh, np.arange(39, dtype=np.float32),
                                    64, fill=-1).numpy()
    two = par.global_mesh(max_devices=2, device_type="cpu")
    coord = two.get_coordinate()
    out["two"] = (two.size(), None if coord is None else list(coord))
    return out


def _jax_push(mesh, JA, semiring, structure_only: bool, edge_cap: int,
              pair_cap, frontier: np.ndarray) -> np.ndarray:
    """JAX's sparse push (pair_cap given) or dense push (None) of
    `frontier` over the partition JA, the whole (n_pad,) result."""
    import jax
    import jax.numpy as jnp

    from graphblast_tpu.parallel import ops as jops

    def step(Ash, fblock):
        f_ind, f_val, f_nv = jops.local_frontier(fblock, 0.0)
        args = (Ash.csr_ptr[0], Ash.csr_ind[0], Ash.csr_val[0], f_ind,
                None if structure_only else f_val, f_nv, semiring, P,
                Ash.rows_per, edge_cap)
        if pair_cap is None:
            return jops.dist_vxm_push(*args, structure_only=structure_only)
        return jops.dist_vxm_push_sparse(*args, pair_cap,
                                         structure_only=structure_only)

    spec = jax.sharding.PartitionSpec
    fn = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(spec("x", None), spec("x")),
        out_specs=spec("x"), check_vma=False))
    sh = jax.sharding.NamedSharding(mesh, spec("x"))
    return np.asarray(fn(JA, jax.device_put(jnp.asarray(frontier), sh)))


def _jax_owner_counts(mesh, JA, frontier: np.ndarray) -> np.ndarray:
    """JAX's owner_buckets counts of `frontier`, (P, P): row k is rank
    k's."""
    import jax
    import jax.numpy as jnp

    from graphblast_tpu.parallel import ops as jops
    from graphblast_tpu.semiring import LogicalOrAndSemiring

    edge_cap = int(JA.csr_ind.shape[1])

    def probe(Ash, fblock):
        f_ind, _, f_nv = jops.local_frontier(fblock, 0.0)
        _, _, _, (_, counts) = jops.owner_buckets(
            Ash.csr_ptr[0], Ash.csr_ind[0], Ash.csr_val[0], f_ind, None,
            f_nv, LogicalOrAndSemiring, P, JA.rows_per, edge_cap, True,
            jnp.float32)
        return counts[None, :]

    spec = jax.sharding.PartitionSpec
    fn = jax.jit(jax.shard_map(probe, mesh=mesh, in_specs=(
        spec("x", None), spec("x")), out_specs=spec("x", None),
        check_vma=False))
    sh = jax.sharding.NamedSharding(mesh, spec("x"))
    return np.asarray(fn(JA, jax.device_put(jnp.asarray(frontier), sh)))


def _jax_weights(seed: int, rows_per: int, n: int) -> list:
    """Each rank's block of the JAX package's MIS / colouring weights
    (parallel/algorithms.py _shard_weights, outside shard_map)."""
    import jax
    import jax.numpy as jnp

    out = []
    for k in range(P):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), k)
        w = np.asarray(jax.random.randint(key, (rows_per,), 1, 2 ** 30,
                                          dtype=jnp.int32))
        gids = k * rows_per + np.arange(rows_per)
        out.append(np.where(gids < n, w, 0).astype(np.int32))
    return out


def _default_pair_cap(edge_cap: int) -> int:
    """The JAX make_bfs_dist's default pair_cap for this edge_cap."""
    pair_cap = max(-(-max(edge_cap // P, 256) // 256) * 256, 256)
    return min(pair_cap, edge_cap)


def _jax_second_half(mesh, mesh2, J, JA, src: int) -> dict:
    """The JAX package's results of the second half of the layer on one
    graph."""
    import graphblast_tpu as jgb
    from graphblast_tpu.matrix import Matrix as JMatrix
    from graphblast_tpu.operations import tril
    from graphblast_tpu.parallel import (bfs_dist, gc_dist, mis_dist,
                                         mxv_2d, mxv_ring, partition_2d,
                                         partition_ring, pr_dist, tc_dist)
    from graphblast_tpu.parallel.algorithms import _tc_prepare
    from graphblast_tpu.parallel.partition import _content_fingerprint

    out = {}
    for tag, kw in DUAL.items():
        out[tag] = bfs_dist(J, src, mesh, jgb.BFS_TUNED.replace(**kw),
                            mode="dual", Ash=JA)
    edge_cap = int(JA.csr_ind.shape[1])
    out["pair_cap"] = _default_pair_cap(edge_cap)
    f = _push_frontier(JA.n_pad)
    for name in PUSH_SEMIRINGS:
        semiring = getattr(jgb, name + "Semiring")
        so = name == "LogicalOrAnd"
        out["push", name] = _jax_push(mesh, JA, semiring, so, edge_cap,
                                      out["pair_cap"], f)
    out["counts"] = []
    for fsize in (3, 12, JA.n):
        fr = np.zeros(JA.n_pad, np.float32)
        fr[:fsize] = 1.0
        out["counts"].append(_jax_owner_counts(mesh, JA, fr))
    R = partition_ring(J, mesh)
    out["ring_arrays"] = {k: np.asarray(getattr(R, k))
                          for k in ("ptr", "ind", "val")}
    A2 = partition_2d(J, mesh2)
    out["2d_arrays"] = {k: np.asarray(getattr(A2, k))
                        for k in ("ptr", "ind", "val")}
    for name in PUSH_SEMIRINGS:
        semiring = getattr(jgb, name + "Semiring")
        x = _mxv_x(J.nrows, name)
        out["ring", name] = mxv_ring(J, mesh, x, semiring, Ash=R)
        out["2d", name] = mxv_2d(A2, mesh2, x, semiring)
    out["pr_ring"] = pr_dist(J, mesh, alpha=0.85, eps=PR_EPS, comm="ring")
    out["pr_2d"] = pr_dist(J, mesh2, alpha=0.85, eps=PR_EPS, comm="2d")
    L = tril(J)
    out["tc_prep"] = _tc_prepare(L, P, JA.rows_per)
    out["tc"] = tc_dist(L, mesh)
    r, c, v = _non_unit(L)
    L2 = JMatrix.from_coo(r, c, v, J.nrows, J.ncols)
    out["tc_non_unit"] = tc_dist(L2, mesh)
    out["weights"] = _jax_weights(MIS_SEED, JA.rows_per, JA.n)
    out["mis"] = mis_dist(J, mesh, seed=MIS_SEED, Ash=JA)
    out["gc"] = gc_dist(J, mesh, seed=MIS_SEED, Ash=JA)
    out["fingerprint"] = _content_fingerprint(J)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's partition leaves and results on 4 virtual
    devices, with its plain jnp pulls (GRB_DIST_PALLAS=0)."""
    import jax

    import graphblast_tpu as jgb
    from graphblast_tpu.algorithms.pr import prepare_pr_matrix
    from graphblast_tpu.io.rmat import rmat_matrix as jax_rmat
    from graphblast_tpu.parallel import (bfs_dist, cc_dist, diameter_dist,
                                         lgc_dist, partition, pr_dist,
                                         sssp_dist)

    mesh = jax.make_mesh((P,), ("x",))
    mesh2 = jax.make_mesh((2, 2), ("r", "c"))
    old = os.environ.get("GRB_DIST_PALLAS")
    os.environ["GRB_DIST_PALLAS"] = "0"
    try:
        out = {}
        for g in GRAPHS:
            J = (jgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                                     use_cache=False)
                 if g == "chesapeake" else jax_rmat(10, 8, seed=3))
            src = _hub(J.row_ptr)
            JA = partition(J, mesh)
            JP = partition(prepare_pr_matrix(J, 0.85), mesh)
            out[g] = {
                "J": J, "src": src,
                "arrays": {k: np.asarray(getattr(JA, k)) for k in LEAVES},
                "n": JA.n, "nvals": JA.nvals,
                "bfs_pull": bfs_dist(J, src, mesh, mode="pull", Ash=JA),
                "bfs_auto": bfs_dist(J, src, mesh, mode="auto", Ash=JA),
                "sssp": sssp_dist(J, src, mesh, Ash=JA),
                "cc": cc_dist(J, mesh, Ash=JA),
                "pr": pr_dist(J, mesh, alpha=0.85, eps=PR_EPS, Ash=JP),
                "lgc": lgc_dist(J, src, mesh, alpha=0.15, eps=LGC_EPS,
                                Ash=JA),
                "diameter": diameter_dist(J, 0, 4, mesh, Ash=JA)}
            out[g].update(_jax_second_half(mesh, mesh2, J, JA, src))
    finally:
        if old is None:
            del os.environ["GRB_DIST_PALLAS"]
        else:
            os.environ["GRB_DIST_PALLAS"] = old
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    arrays = {g: (jax_side[g]["arrays"], jax_side[g]["n"],
                  jax_side[g]["nvals"]) for g in GRAPHS}
    weights = {g: jax_side[g]["weights"] for g in GRAPHS}
    cache_dir = str(tmp_path_factory.mktemp("shard-cache"))
    return par.launch(_rank_cases, P, arrays, weights, cache_dir,
                      device_type="cpu")


def _same_on_every_rank(ranks, g, key):
    """The entry's result on rank 0, after checking every rank holds the
    same whole array."""
    first = ranks[0][g][key]
    for k in range(1, P):
        np.testing.assert_array_equal(ranks[k][g][key], first)
    return first


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("g", GRAPHS)
def test_partition_arrays_equal_jax(ranks, jax_side, g, leaf):
    """Rank k's block arrays equal row k of the JAX leaves, dtype and
    padding (the n_pad sentinel, the capacity) included."""
    want = jax_side[g]["arrays"][leaf]
    assert want.shape[0] == P
    for k in range(P):
        got = ranks[k][g]["arrays"][leaf]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want[k])


@pytest.mark.parametrize("g", GRAPHS)
def test_from_jax_arrays_round_trips(ranks, jax_side, g):
    """ShardedMatrix.from_jax_arrays keeps row `rank` of each JAX leaf,
    and BFS over it equals BFS over the port's own partition."""
    for k in range(P):
        for leaf in LEAVES:
            np.testing.assert_array_equal(ranks[k][g]["from_jax"][leaf],
                                          ranks[k][g]["arrays"][leaf])
    np.testing.assert_array_equal(_same_on_every_rank(ranks, g,
                                                      "from_jax_bfs"),
                                  jax_side[g]["bfs_pull"])


@pytest.mark.parametrize("mode", ["pull", "auto"])
@pytest.mark.parametrize("g", GRAPHS)
def test_bfs_dist_equals_jax_and_golden(ranks, jax_side, g, mode):
    from graphblast_tpu.algorithms.reference import bfs_cpu

    got = _same_on_every_rank(ranks, g, f"bfs_{mode}")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_side[g][f"bfs_{mode}"])
    np.testing.assert_array_equal(got, bfs_cpu(jax_side[g]["J"],
                                               jax_side[g]["src"]))


@pytest.mark.parametrize("variant", ["bfs_push", "bfs_pullonly_auto",
                                     "bfs_values", "own_partition_bfs",
                                     "bfs_pull_again"])
@pytest.mark.parametrize("g", GRAPHS)
def test_bfs_dist_variants_equal_the_golden(ranks, jax_side, g, variant):
    """The stepped BFS pushing every iteration (switchpoint 1; each push
    routes its partial by the all-to-all of LogicalOr), PULLONLY in the
    stepped loop, the pull of values (not structure-only: spmv_pull's
    LogicalOrAnd fold), the pull over the partition bfs_dist builds itself
    and a second pull over the kept K1 plan all give the golden levels."""
    from graphblast_tpu.algorithms.reference import bfs_cpu

    got = _same_on_every_rank(ranks, g, variant)
    np.testing.assert_array_equal(got, bfs_cpu(jax_side[g]["J"],
                                               jax_side[g]["src"]))


@pytest.mark.parametrize("g", GRAPHS)
def test_stepped_bfs_picks_its_direction(ranks, jax_side, g):
    """The stepped loop pulls where the frontier's density passes the
    switchpoint (0.01) and pushes elsewhere; at switchpoint 1 it only
    pushes."""
    from graphblast_tpu.algorithms.reference import bfs_cpu

    levels = bfs_cpu(jax_side[g]["J"], jax_side[g]["src"])
    n = len(levels)
    want = sum(int((levels == it).sum()) / n > 0.01
               for it in range(1, int(levels.max()) + 1))
    for k in range(P):
        assert ranks[k][g]["bfs_auto_pulls"] == want
        assert ranks[k][g]["bfs_push_pulls"] == 0


@pytest.mark.parametrize("g", GRAPHS)
def test_sssp_dist_matches_jax(ranks, jax_side, g):
    from graphblast_tpu.algorithms.reference import sssp_cpu

    got = _same_on_every_rank(ranks, g, "sssp")
    np.testing.assert_allclose(got, jax_side[g]["sssp"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, sssp_cpu(jax_side[g]["J"],
                                             jax_side[g]["src"]),
                               rtol=1e-6)


@pytest.mark.parametrize("g", GRAPHS)
def test_cc_dist_matches_jax_and_the_golden_partition(ranks, jax_side, g):
    from graphblast_tpu.algorithms.reference import cc_cpu

    got = _same_on_every_rank(ranks, g, "cc")
    np.testing.assert_array_equal(got, jax_side[g]["cc"])
    want = cc_cpu(jax_side[g]["J"])
    # the same partition of the vertices: labels map one to one
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == len(set(got.tolist())) == len(set(want.tolist()))


@pytest.mark.parametrize("g", GRAPHS)
def test_pr_dist_matches_jax_and_the_single_device_port(ranks, jax_side,
                                                        g):
    """pr_dist over the value-pull plan, on the partition it builds and
    on a caller's partition of the prepared matrix, within 1e-5 of JAX's
    pr_dist and of the port's pr on one device."""
    got = _same_on_every_rank(ranks, g, "pr")
    given = _same_on_every_rank(ranks, g, "pr_given")
    single = tgb.algorithms.pr(_port_graph(g), alpha=0.85,
                               eps=PR_EPS).to_numpy()
    for want in (jax_side[g]["pr"], single):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(given, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("g", GRAPHS)
def test_lgc_dist_matches_jax(ranks, jax_side, g):
    got = _same_on_every_rank(ranks, g, "lgc")
    np.testing.assert_allclose(got, jax_side[g]["lgc"], rtol=1e-4,
                               atol=1e-7)
    single = tgb.algorithms.lgc(_port_graph(g), jax_side[g]["src"],
                                alpha=0.15, eps=LGC_EPS).to_numpy()
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("g", GRAPHS)
def test_diameter_dist_equals_jax(ranks, jax_side, g):
    for k in range(P):
        assert ranks[k][g]["diameter"] == jax_side[g]["diameter"]


@pytest.mark.parametrize("g", GRAPHS)
def test_plans_are_built_at_first_use_and_kept(ranks, g):
    """partition builds no plan; the first pull builds the block's K1 plan
    and the value-pull plan over the block's one schedule, and later pulls
    reuse them."""
    for k in range(P):
        assert ranks[k][g]["plans_before"] == []
        assert ranks[k][g]["plan_kept"]
        assert ranks[k][g]["value_plan_kept"]


@pytest.mark.parametrize("semiring", ["PlusMultiplies", "LogicalOrAnd",
                                      "MinimumPlus"])
def test_combine_partials_matches_a_host_fold(ranks, semiring):
    """_combine_partials gives rank k the ⊕ over the ranks of block k of
    their partials: a reduce-scatter for Plus, the all-to-all and fold for
    LogicalOr and Min."""
    fold = {"PlusMultiplies": np.add, "LogicalOrAnd": np.logical_or,
            "MinimumPlus": np.minimum}[semiring]
    partials = [ranks[k]["combine"][semiring][0] for k in range(P)]
    rows_per = len(partials[0]) // P
    total = partials[0]
    for p in partials[1:]:
        total = fold(total, p)
    for k in range(P):
        want = total[k * rows_per:(k + 1) * rows_per].astype(np.float32)
        got = ranks[k]["combine"][semiring][1]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("monoid", ["PlusMonoid", "MinimumMonoid",
                                    "MaximumMonoid", "MultipliesMonoid"])
def test_dist_reduce_matches_a_host_reduce(ranks, monoid):
    xs = np.concatenate([ranks[k]["reduce"][monoid][0] for k in range(P)])
    if monoid == "MultipliesMonoid":
        # the fold in rank order over the ranks' products
        want = np.float32(1)
        for k in range(P):
            want = want * np.prod(ranks[k]["reduce"][monoid][0],
                                  dtype=np.float32)
        rtol = 1e-5
    else:
        want = {"PlusMonoid": np.sum, "MinimumMonoid": np.min,
                "MaximumMonoid": np.max}[monoid](xs.astype(np.float64))
        rtol = 1e-5
    for k in range(P):
        assert ranks[k]["reduce"][monoid][1] == pytest.approx(
            float(want), rel=rtol, abs=1e-12)


def test_shard_vector_matches_jax(ranks):
    """Rank k's block of shard_vector equals block k of JAX's."""
    import jax

    from graphblast_tpu.parallel import shard_vector

    want = np.asarray(shard_vector(jax.make_mesh((P,), ("x",)),
                                   np.arange(39, dtype=np.float32), 64,
                                   fill=-1))
    for k in range(P):
        assert ranks[k]["shard"].dtype == want.dtype
        np.testing.assert_array_equal(ranks[k]["shard"],
                                      want[k * 16:(k + 1) * 16])


def test_global_mesh_over_the_first_ranks(ranks):
    """global_mesh(max_devices=2) spans ranks 0 and 1; ranks 2 and 3 are
    not in it."""
    for k in range(P):
        size, coord = ranks[k]["two"]
        assert size == 2
        assert coord == ([k] if k < 2 else None)


def test_the_layer_runs_on_cuda_unless_asked():
    """global_mesh, launch and scaling.py default to cuda, and raise
    without a card instead of running on the CPU."""
    from graphblast_tpu_torch.examples import scaling

    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        par.global_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        par.launch(_rank_cases, 1, {})
    with pytest.raises(RuntimeError, match="cuda"):
        scaling.main(["--scale", "8"])


def _scaling_rows(capsys, algo: str) -> list:
    """examples/scaling.py's output at --scale 8 on 1 and 2 gloo ranks,
    after checking it exits 0."""
    from graphblast_tpu_torch.examples import scaling

    assert scaling.main(["--scale", "8", "--max_procs", "2", "--niter",
                         "1", "--algo", algo, "--device", "cpu"]) == 0
    return capsys.readouterr().out.splitlines()


def _check_scaling_rows(out: list, algo: str) -> None:
    assert out[0].startswith(f"algo={algo} n=256 nnz=") and out[0].endswith(
        "devices=8")
    assert out[1] == "P, ms/run, Medges/s, efficiency_vs_P1"
    assert [line.split(", ")[0] for line in out[2:]] == ["1", "2"]
    assert out[2].endswith(", 100%")


def test_scaling_prints_its_header_and_rows(capsys):
    """examples/scaling.py at --scale 8 on 1 and 2 gloo ranks: exit 0, the
    JAX harness's header, and a row for each P, for cc and for tc (over
    tril(A) and tc_prepare's buckets)."""
    _check_scaling_rows(_scaling_rows(capsys, "cc"), "cc")
    _check_scaling_rows(_scaling_rows(capsys, "tc"), "tc")


@pytest.mark.parametrize("algo", ["mis", "gc"])
def test_scaling_runs_mis_and_colouring(capsys, algo):
    _check_scaling_rows(_scaling_rows(capsys, algo), algo)


# ---------------------------------------------------------------------------
# The second half of the layer: the sparse push, the dual BFS, the ring and
# 2D layouts, TC, MIS and colouring, the partition cache, the accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("semiring", PUSH_SEMIRINGS)
@pytest.mark.parametrize("g", GRAPHS)
def test_sparse_push_equals_jax(ranks, jax_side, g, semiring):
    """dist_vxm_push_sparse over each rank's block of a seeded frontier
    equals JAX's: LogicalOrAnd (structure-only) and MinimumPlus exactly,
    PlusMultiplies within 1e-5 relative (the sums' order differs; they
    reach about 100, where 1e-5 absolute is below two float32 steps)."""
    assert ranks[0][g]["push"]["pair_cap"] == jax_side[g]["pair_cap"]
    got = ranks[0][g]["push"][semiring, "sparse"]
    for k in range(1, P):
        np.testing.assert_array_equal(ranks[k][g]["push"][semiring,
                                                          "sparse"], got)
    want = jax_side[g]["push", semiring]
    if semiring == "PlusMultiplies":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("semiring", PUSH_SEMIRINGS)
@pytest.mark.parametrize("g", GRAPHS)
def test_sparse_push_overflow_takes_the_dense_push(ranks, g, semiring):
    """With pair_cap 8 some rank's bucket overflows, every rank takes the
    dense push, and the result equals the dense push's; with the default
    pair_cap the sparse exchange equals it too (Plus within 1e-5
    relative)."""
    assert max(int(ranks[k][g]["push"]["frontier_counts"].max())
               for k in range(P)) > TINY_PAIR_CAP
    dense = ranks[0][g]["push"][semiring, "dense"]
    np.testing.assert_array_equal(ranks[0][g]["push"][semiring, "overflow"],
                                  dense)
    np.testing.assert_allclose(ranks[0][g]["push"][semiring, "sparse"],
                               dense, rtol=1e-5, atol=0)


def test_sparse_push_bucket_near_buffer_end(ranks):
    """A bucket that starts within pair_cap of the end of the sorted lanes
    takes no other owner's pairs: the sparse push reaches exactly the
    columns of rows 0 and 1, as the dense push does."""
    for k in range(P):
        case = ranks[k]["near_end"]
        np.testing.assert_array_equal(case["dense"] != 0, case["want"])
        np.testing.assert_array_equal(case["sparse"] != 0, case["want"])


@pytest.mark.parametrize("g", GRAPHS)
def test_owner_buckets_counts_equal_jax_and_the_accounting(ranks, jax_side,
                                                          g):
    """owner_buckets' live pair counts for the first 3, the first 12 and
    all vertices as the frontier: rank k's equal row k of JAX's and of
    accounting.sparse_push_live_pairs, and the pairs sent off the rank
    grow with the frontier."""
    from graphblast_tpu_torch.parallel.accounting import (
        sparse_push_live_pairs)

    J = jax_side[g]["J"]
    n, n_pad = jax_side[g]["n"], P * (jax_side[g]["arrays"]["csr_ptr"]
                                      .shape[1] - 1)
    ptr = np.zeros(n_pad + 1, np.int64)
    pn = np.asarray(J.row_ptr)[:n + 1]
    ptr[:n + 1] = pn
    ptr[n + 1:] = pn[-1]
    ci = np.asarray(J.col_ind)[:J.nvals]
    off = []
    for i, fsize in enumerate((3, 12, n)):
        f = np.zeros(n_pad, bool)
        f[:fsize] = True
        want = sparse_push_live_pairs(ptr, ci, f, P, n_pad // P)
        np.testing.assert_array_equal(jax_side[g]["counts"][i], want)
        for k in range(P):
            np.testing.assert_array_equal(ranks[k][g]["push"]["counts"][i],
                                          want[k])
        off.append(int(want.sum() - np.trace(want)))
    assert off[0] < off[1] < off[2], off


@pytest.mark.parametrize("variant", list(DUAL))
@pytest.mark.parametrize("g", GRAPHS)
def test_bfs_dual_equals_jax_and_golden(ranks, jax_side, g, variant):
    from graphblast_tpu.algorithms.reference import bfs_cpu

    got = _same_on_every_rank(ranks, g, variant)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_side[g][variant])
    np.testing.assert_array_equal(got, bfs_cpu(jax_side[g]["J"],
                                               jax_side[g]["src"]))


@pytest.mark.parametrize("variant", ["dual_values", "dual_tiny_pair_cap"])
@pytest.mark.parametrize("g", GRAPHS)
def test_bfs_dual_variants_equal_the_golden(ranks, jax_side, g, variant):
    """The dual BFS over values (not structure-only: the push carries the
    frontier's values, the pull runs spmv_pull) and make_bfs_dist(dual=
    True) with pair_cap 8 (its pushes overflow into the dense push) give
    the golden levels."""
    from graphblast_tpu.algorithms.reference import bfs_cpu

    got = _same_on_every_rank(ranks, g, variant)
    np.testing.assert_array_equal(got, bfs_cpu(jax_side[g]["J"],
                                               jax_side[g]["src"]))


@pytest.mark.parametrize("variant", list(DUAL) + ["dual_tiny"])
@pytest.mark.parametrize("g", GRAPHS)
def test_bfs_dual_directions_follow_jax_rule(ranks, jax_side, g, variant):
    """Each iteration's direction, recomputed on the host from the golden
    levels by the JAX loop's rule: push iff the frontier's count over
    n_pad is at most the switchpoint and the most frontier edges of any
    rank's row block is at most edge_cap (no PULLONLY check). The
    recorded counts and edge maxima equal the host's, and the loop reads
    the host at most twice an iteration."""
    from graphblast_tpu.algorithms.reference import bfs_cpu

    kw = DUAL.get(variant, {"switchpoint": 1.0})
    switchpoint = tgb.BFS_TUNED.replace(**kw).switchpoint
    levels = bfs_cpu(jax_side[g]["J"], jax_side[g]["src"])
    deg = np.diff(np.asarray(jax_side[g]["J"].row_ptr)[:len(levels) + 1])
    rows_per = jax_side[g]["arrays"]["csr_ptr"].shape[1] - 1
    n_pad = P * rows_per
    for k in range(P):
        run = ranks[k][g][variant + "_run"]
        want = []
        for it in range(1, int(levels.max()) + 1):
            front = np.flatnonzero(levels == it)
            succ = len(front)
            deg_max = int(np.bincount(front // rows_per, weights=deg[front],
                                      minlength=P).max())
            push = succ / n_pad <= switchpoint and deg_max <= run["edge_cap"]
            want.append((succ, deg_max, "push" if push else "pull"))
        assert [tuple(d) for d in run["directions"]] == want
        assert run["iterations"] == len(want)
        assert run["host_reads"] <= 2 * run["iterations"] + 1
    if variant == "dual_sp1":
        assert any(d[2] == "push" for d in want)
    if variant == "dual_tight" and g == "rmat10":
        assert {d[2] for d in want} == {"push", "pull"}


@pytest.mark.parametrize("leaf", ["ptr", "ind", "val"])
@pytest.mark.parametrize("layout", ["ring", "2d"])
@pytest.mark.parametrize("g", GRAPHS)
def test_ring_and_2d_partition_arrays_equal_jax(ranks, jax_side, g, layout,
                                                leaf):
    """Rank k's ring arrays equal row k of JAX's (P, P, ·) leaves; rank
    (i, j)'s 2D block equals JAX's (R, C, ·) leaves at [i, j], with the
    padding and its sentinel."""
    want = jax_side[g][f"{layout}_arrays"][leaf]
    for k in range(P):
        got = ranks[k][g][f"{layout}_arrays"][leaf]
        if layout == "ring":
            ref = want[k]
        else:
            i, j = ranks[k][g]["2d_coords"]
            assert (i, j) == (k // 2, k % 2)
            ref = want[i, j]
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("semiring", PUSH_SEMIRINGS + ("struct",))
@pytest.mark.parametrize("layout", ["ring", "2d"])
@pytest.mark.parametrize("g", GRAPHS)
def test_mxv_ring_and_2d_equal_jax(ranks, jax_side, g, layout, semiring):
    """mxv_ring and mxv_2d equal JAX's under LogicalOrAnd (also the
    structure-only or-pull, K5's route) and MinimumPlus exactly, and
    under PlusMultiplies within 1e-5·max|y| of JAX's and of a float64
    golden (fp32 sums added in another order; JAX's segmented sums of
    rmat10's rows of many hundreds stray by up to 5e-6·max|y|)."""
    got = _same_on_every_rank(ranks, g, (layout, semiring))
    want = jax_side[g][layout, "LogicalOrAnd" if semiring == "struct"
                       else semiring]
    assert got.shape == want.shape
    if semiring == "PlusMultiplies":
        r, c, v = jax_side[g]["J"].extract_tuples()
        x = _mxv_x(len(got), semiring)
        gold = np.zeros(len(got))
        np.add.at(gold, np.asarray(r), np.asarray(v, np.float64) * x[c])
        bar = 1e-5 * np.abs(gold).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=bar)
        np.testing.assert_allclose(got, gold, rtol=0, atol=bar)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["ring", "2d"])
@pytest.mark.parametrize("g", GRAPHS)
def test_pr_ring_and_2d_match_jax(ranks, jax_side, g, layout):
    """pr_dist(comm='ring') and (comm='2d') within 1e-5 of JAX's, and of
    the port's all-gather pr_dist."""
    got = _same_on_every_rank(ranks, g, f"pr_{layout}")
    np.testing.assert_allclose(got, jax_side[g][f"pr_{layout}"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got, _same_on_every_rank(ranks, g, "pr"),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("g", GRAPHS)
def test_tc_prepare_arrays_equal_jax(ranks, jax_side, g):
    """Rank k's mask-edge buckets (ei, ej), their counts, mcap and ec
    equal row k of JAX's _tc_prepare."""
    ei, ej, cnt, mcap, ec = jax_side[g]["tc_prep"]
    for k in range(P):
        gei, gej, gcnt, gmcap, gec, unit = ranks[k][g]["tc_prep"]
        np.testing.assert_array_equal(gei, ei[k])
        np.testing.assert_array_equal(gej, ej[k])
        assert gcnt == cnt[k].tolist()
        assert (gmcap, gec, unit) == (mcap, ec, True)


@pytest.mark.parametrize("g", GRAPHS)
def test_tc_dist_equals_jax_and_goldens(ranks, jax_side, g):
    """tc_dist of tril(A) on every rank (over a prep, again over it, and
    over its own) equals JAX's tc_dist, tc_cpu and the port's tc."""
    from graphblast_tpu.algorithms.reference import tc_cpu
    from graphblast_tpu.operations import tril

    want = jax_side[g]["tc"]
    assert want == tc_cpu(tril(jax_side[g]["J"]))
    assert want == tgb.algorithms.tc(tgb.tril(_port_graph(g)))
    for k in range(P):
        for key in ("tc", "tc_again", "tc_own"):
            assert ranks[k][g][key] == want


@pytest.mark.parametrize("g", GRAPHS)
def test_tc_dist_non_unit_values_equal_jax(ranks, jax_side, g):
    """A lower triangle with values 1 + (i + j) mod 3: tc_prepare sees
    they are not all 1, each stage folds PlusMultiplies (T2), and the
    rounded sum equals JAX's."""
    for k in range(P):
        total, unit = ranks[k][g]["tc_non_unit"]
        assert not unit
        assert total == jax_side[g]["tc_non_unit"]
    assert jax_side[g]["tc_non_unit"] > jax_side[g]["tc"]


@pytest.mark.parametrize("algo", ["mis", "gc"])
@pytest.mark.parametrize("g", GRAPHS)
def test_mis_and_gc_with_jax_weights_equal_jax(ranks, jax_side, g, algo):
    """make_mis_dist / make_gc_dist handed each rank's block of the JAX
    package's weights equal JAX's mis_dist / gc_dist exactly."""
    got = _same_on_every_rank(ranks, g, f"{algo}_jax_w")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_side[g][algo])


@pytest.mark.parametrize("algo", ["mis", "gc"])
@pytest.mark.parametrize("g", GRAPHS)
def test_mis_and_gc_with_own_weights_verify(ranks, jax_side, g, algo):
    """mis_dist and gc_dist with the port's own seeded weights: the same
    result on every rank, a maximal independent set, a proper colouring
    of every vertex."""
    from graphblast_tpu.algorithms.reference import verify_gc, verify_mis

    got = _same_on_every_rank(ranks, g, algo)
    if algo == "mis":
        assert verify_mis(jax_side[g]["J"], got)
        assert got.sum() > 0
    else:
        assert verify_gc(jax_side[g]["J"], got)
        assert got.min() >= 1


@pytest.mark.parametrize("g", GRAPHS)
def test_partition_cache_round_trips(ranks, g):
    """partition_cached writes one file a rank, named for its rank, and a
    second call loads arrays equal to those it built."""
    for k in range(P):
        c = ranks[k][g]["cache"]
        assert c["saved"]
        name = f".graph.p{P}.r{k}.shards.torch.npz"
        assert os.path.basename(c["path"]) == name
        for leaf in LEAVES:
            np.testing.assert_array_equal(c["loaded"][leaf],
                                          c["built"][leaf])
            np.testing.assert_array_equal(c["built"][leaf],
                                          ranks[k][g]["arrays"][leaf])


@pytest.mark.parametrize("g", GRAPHS)
def test_partition_cache_rebuilds_a_changed_graph(ranks, g):
    """One value changed: the fingerprint changes and partition_cached
    builds the new graph's blocks instead of loading the old ones."""
    for k in range(P):
        c = ranks[k][g]["cache"]
        assert c["fingerprints"][0] != c["fingerprints"][1]
        for leaf in LEAVES:
            np.testing.assert_array_equal(c["rebuilt"][leaf],
                                          c["fresh_B"][leaf])
    # the changed entry lies in one rank's row block
    assert sum(not np.array_equal(ranks[k][g]["cache"]["rebuilt"]["csr_val"],
                                  ranks[k][g]["cache"]["built"]["csr_val"])
               for k in range(P)) == 1


@pytest.mark.parametrize("g", GRAPHS)
def test_partition_cache_in_an_unwritable_place_builds(ranks, g):
    """Where the file cannot be written (its directory does not exist,
    so saving raises OSError), partition_cached builds and writes
    nothing."""
    for k in range(P):
        c = ranks[k][g]["cache"]
        assert not c["nowhere_written"]
        for leaf in LEAVES:
            np.testing.assert_array_equal(c["unsaved"][leaf],
                                          c["built"][leaf])


@pytest.mark.parametrize("g", GRAPHS)
def test_content_fingerprint_equals_jax(ranks, jax_side, g):
    from graphblast_tpu_torch.parallel.partition import _content_fingerprint

    assert _content_fingerprint(_port_graph(g)) == jax_side[g]["fingerprint"]
    for k in range(P):
        assert ranks[k][g]["cache"]["fingerprints"][0] == \
            jax_side[g]["fingerprint"]


ACCOUNTING_CASES = {
    "pull_allgather": (1_000_000, 8, 131_072),
    "push_dense": (50_000, 8, 131_072),
    "push_sparse": (8, 4096, 50_000),
    "pr_ring": (1_000_000, 8, 131_072),
    "pr_2d": (1_000_000, 2, 4, 131_072),
    "tc_ring": (1_000_000, 8),
}


@pytest.mark.parametrize("fn", list(ACCOUNTING_CASES))
def test_accounting_rows_equal_jax(fn):
    """Each CommRow equals the JAX package's for the same inputs, and so
    does its efficiency at the same rates."""
    import dataclasses

    from graphblast_tpu.parallel import accounting as jacc
    from graphblast_tpu_torch.parallel import accounting as tacc

    args = ACCOUNTING_CASES[fn]
    got, want = getattr(tacc, fn)(*args), getattr(jacc, fn)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.efficiency(3350.0, 450.0) == want.efficiency(3350.0, 450.0)


def test_accounting_live_pairs_and_report_equal_jax():
    """sparse_push_live_pairs equals JAX's on a seeded graph and frontier;
    report's rows equal JAX's at the same rates, and its defaults are the
    H100 datasheet figures, not a TPU's."""
    from graphblast_tpu.parallel import accounting as jacc
    from graphblast_tpu_torch.parallel import accounting as tacc

    rng = np.random.default_rng(17)
    deg = rng.integers(0, 9, 64)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    ind = rng.integers(0, 64, ptr[-1])
    f = rng.random(64) < 0.3
    np.testing.assert_array_equal(
        tacc.sparse_push_live_pairs(ptr, ind, f, 4, 16),
        jacc.sparse_push_live_pairs(ptr, ind, f, 4, 16))
    args = (1 << 18, 1 << 23, 8, 4096, 1 << 20)
    got = tacc.report(*args, 3350.0, 450.0, 64.0).splitlines()
    want = jacc.report(*args, 3350.0, 450.0, 64.0).splitlines()
    assert got[2:] == want[2:]
    assert "link 450" in got[0] and "ICI" not in got[0]
    assert tacc.report(*args) == "\n".join(got)


def test_comm_report_prints_a_row_for_each_algorithm(capsys, tmp_path):
    from graphblast_tpu_torch.examples import comm_report

    assert comm_report.main([]) == 0
    out = capsys.readouterr().out
    assert "NVLink" in out and "ICI" not in out and "v5p" not in out
    for algo in ("bfs/pr pull", "push (dense partial)",
                 "push (sparse exchange)", "pr (ring)", "pr (2d SUMMA)",
                 "tc (ring)"):
        assert out.count(f"| {algo} |") == 6
    path = tmp_path / "comm.md"
    assert comm_report.main(["--out", str(path)]) == 0
    assert path.read_text() == out
