"""The port's distributed layer (`graphblast_tpu_torch.parallel`) on 4 gloo
ranks on the CPU, held against the JAX package's on its virtual mesh of
the same 4 devices (`jax.make_mesh((4,), ("x",))`, of the conftest's 8).

One spawn for the whole module: `_rank_cases` runs every distributed case
on each of the 4 ranks (parallel.bootstrap.launch, a file:// store under a
temporary directory, so parallel test workers never share a port) and
returns its results, which the tests below read. The JAX side runs in this
process with the JAX package's own GRB_DIST_PALLAS=0, so that its pulls
take their plain jnp route (the Pallas plans give the same results, which
the JAX package's own tests hold, at many times the CPU time in interpret
mode).

Tolerances: the partition arrays, BFS levels, CC labels and the diameter
are exact; SSSP within 1e-4, PageRank within 1e-5 and LGC within rtol 1e-4
/ atol 1e-7 (the JAX test_lgc_dist_matches_single_chip bar) of JAX's.
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


def _port_graph(name: str):
    if name == "chesapeake":
        return tgb.Matrix.from_mtx(os.path.join(DATA, "chesapeake.mtx"),
                                   use_cache=False, device="cpu")
    return rmat_matrix(10, 8, seed=3, device="cpu")


def _hub(ptr) -> int:
    return int(np.argmax(np.diff(np.asarray(ptr))))


def _rank_cases(mesh, jax_arrays: dict) -> dict:
    """Every distributed case on this rank; runs in each spawned rank."""
    from graphblast_tpu_torch.algorithms.pr import prepare_pr_matrix
    from graphblast_tpu_torch.parallel.ops import (_combine_partials,
                                                   dist_reduce)

    group = mesh.get_group("x")
    rank = mesh.get_local_rank("x")
    out = {}
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
    finally:
        if old is None:
            del os.environ["GRB_DIST_PALLAS"]
        else:
            os.environ["GRB_DIST_PALLAS"] = old
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    arrays = {g: (jax_side[g]["arrays"], jax_side[g]["n"],
                  jax_side[g]["nvals"]) for g in GRAPHS}
    return par.launch(_rank_cases, P, arrays, device_type="cpu")


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


@pytest.mark.parametrize("call", [
    lambda A: par.bfs_dist(A, 0, None, mode="dual"),
    lambda A: par.make_bfs_dist(None, None, dual=True),
    lambda A: par.pr_dist(A, None, comm="ring"),
    lambda A: par.pr_dist(A, None, comm="2d"),
    lambda A: par.tc_dist(A, None),
    lambda A: par.tc_prepare(A, None),
    lambda A: par.mis_dist(A, None),
    lambda A: par.make_mis_dist(None, None),
    lambda A: par.gc_dist(A, None),
    lambda A: par.make_gc_dist(None, None),
    lambda A: par.make_pr_ring_dist(None, None),
    lambda A: par.make_pr_2d_dist(None, None),
], ids=["bfs_dual", "make_bfs_dual", "pr_ring", "pr_2d", "tc_dist",
        "tc_prepare", "mis_dist", "make_mis_dist", "gc_dist",
        "make_gc_dist", "make_pr_ring_dist", "make_pr_2d_dist"])
def test_second_half_entries_raise_naming_item_10b(call):
    with pytest.raises(NotImplementedError, match="item 10b"):
        call(_port_graph("chesapeake"))


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


def test_scaling_prints_its_header_and_rows(capsys):
    """examples/scaling.py at --scale 8 on 1 and 2 gloo ranks: exit 0, the
    JAX harness's header, and a row for each P; --algo tc waits for item
    10b."""
    from graphblast_tpu_torch.examples import scaling

    assert scaling.main(["--scale", "8", "--max_procs", "2", "--niter",
                         "1", "--algo", "cc", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("algo=cc n=256 nnz=") and out[0].endswith(
        "devices=8")
    assert out[1] == "P, ms/run, Medges/s, efficiency_vs_P1"
    assert [line.split(", ")[0] for line in out[2:]] == ["1", "2"]
    assert out[2].endswith(", 100%")
    with pytest.raises(SystemExit, match="item 10b"):
        scaling.main(["--algo", "tc"])
