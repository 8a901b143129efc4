"""The port's CLI machinery (`graphblast_tpu_torch.utils`) and its ten
drivers (`graphblast_tpu_torch.examples`: gbfs, gsssp, gdiameter, glgc,
gpr, gcc, gmis, ggc, ggc_cusparse, gtc) against the JAX package's, on the
CPU (`--device cpu`).

Every check is exact: descriptor fields, graph arrays, the drivers' exit
codes and their CORRECT / INCORRECT lines (the drivers verify exactly for
BFS, the diameter and TC, within the reference's 1e-3 for SSSP and LGC and
1e-2 for PageRank, and with the property verifiers for CC, MIS and the
colourings).
"""
import argparse
import os
import re

import numpy as np
import pytest
import torch

import graphblast_tpu_torch as tgb
from graphblast_tpu.utils import cli as jcli
from graphblast_tpu_torch.examples import (gbfs, gcc, gdiameter, ggc,
                                           ggc_cusparse, glgc, gmis, gpr,
                                           gsssp, gtc)
from graphblast_tpu_torch.utils import cli as tcli
from graphblast_tpu_torch.utils import profiling, verify_list

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "small")
CHESAPEAKE = os.path.join(DATA, "chesapeake.mtx")
# each driver and the line it prints when it verifies
DRIVERS = {"gbfs": (gbfs, "BFS: CORRECT"), "gsssp": (gsssp, "SSSP: CORRECT"),
           "gdiameter": (gdiameter, "CORRECT"), "glgc": (glgc, "LGC: CORRECT"),
           "gpr": (gpr, "PR: CORRECT"), "gcc": (gcc, "CC: CORRECT"),
           "gmis": (gmis, "MIS: CORRECT"),
           "ggc": (ggc, r"^GC\[CORRECT\]: colors=[1-9][0-9]*"),
           "ggc_cusparse": (ggc_cusparse,
                            r"^GC\[CORRECT\]: colors=[1-9][0-9]*"),
           "gtc": (gtc, r"^TC: ntris=[0-9]+ golden=[0-9]+ CORRECT")}


def _verified(out, correct) -> bool:
    """Whether a line of `out` ends with `correct` (a regex match for the
    drivers whose line carries a number)."""
    if correct.startswith("^"):
        return any(re.match(correct + "$", line) for line in out)
    return any(line.endswith(correct) for line in out)


def _parse(module, argv):
    return module.build_parser("g", "").parse_args(argv)


@pytest.mark.parametrize("mxvmode", [0, 1, 2])
def test_descriptor_from_args_matches_jax(mxvmode):
    """Each --mxvmode (0 PUSHPULL, 1 PUSHONLY, 2 PULLONLY) and the tuned
    BFS flags give the JAX descriptor, field by field (the Direction and
    LoadBalanceMode enums by name). `backend`, which picks between the
    ops on the device and the host-functor path, names each package's
    device path by default: "tpu" in JAX's, "device" in the port's. JAX's
    `push_tiers` has no field in the port, which sizes each push from its
    degree total."""
    argv = ["g.mtx", "--mxvmode", str(mxvmode), "--struconly", "1",
            "--earlyexit", "1", "--opreuse", "1", "--switchpoint", "0.05",
            "--memusage", "0.5", "--sort", "0", "--max_niter", "7",
            "--timing", "1", "--dirinfo", "--seed", "3"]
    jd = jcli.descriptor_from_args(_parse(jcli, argv))
    td = tcli.descriptor_from_args(_parse(tcli, argv))
    assert (set(jd.__dataclass_fields__) - {"push_tiers"}
            == set(td.__dataclass_fields__))
    assert (jd.backend, td.backend) == ("tpu", "device")
    for field in set(td.__dataclass_fields__) - {"backend"}:
        a, b = getattr(jd, field), getattr(td, field)
        if hasattr(a, "name"):
            a, b = a.name, b.name
        assert a == b, field
    assert td.mxv_mode.name == ("PUSHPULL", "PUSHONLY", "PULLONLY")[mxvmode]


def test_parser_matches_jax_but_for_device():
    """The same flags and defaults as the JAX parser, and one more:
    --device, default cuda."""
    jargs = vars(_parse(jcli, ["g.mtx"]))
    targs = vars(_parse(tcli, ["g.mtx"]))
    assert targs.pop("device") == "cuda"
    assert targs == jargs


def test_load_graph_matches_jax_and_transposes():
    """load_graph on an .mtx and an rmat: pseudo-path builds the JAX
    package's graph on --device; --transpose swaps the orientations
    without a copy (operations.transpose), equal to the JAX transpose."""
    from graphblast_tpu.operations import transpose as jtranspose

    for argv in (["rmat:8:4:5"], [CHESAPEAKE], ["rmat:7:8", "--directed",
                                                "1", "--seed", "2"]):
        for extra in ([], ["--transpose"]):
            J = jcli.load_graph(_parse(jcli, argv + extra))
            T = tcli.load_graph(_parse(tcli, argv + extra + ["--device",
                                                             "cpu"]))
            assert (T.nrows, T.ncols, T.nvals) == (J.nrows, J.ncols, J.nvals)
            assert T.device.type == "cpu"
            for leaf in tgb.matrix.LEAVES:
                a, b = getattr(J, leaf), getattr(T, leaf)
                assert (a is None) == (b is None), leaf
                if a is not None:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    J = jcli.load_graph(_parse(jcli, ["rmat:7:8", "--directed", "1"]))
    T = tcli.load_graph(_parse(tcli, ["rmat:7:8", "--directed", "1",
                                      "--device", "cpu"]))
    Tt = tgb.transpose(T)
    assert Tt.row_ptr is T.col_ptr and Tt.col_ptr is T.row_ptr
    np.testing.assert_array_equal(Tt.host_csr()[0],
                                  np.asarray(jtranspose(J).row_ptr))
    C = tgb.Matrix.from_coo(*T.extract_tuples(), T.nrows, T.ncols,
                            fmt=tgb.SparseFormat.CSRONLY, device="cpu")
    Ct = tgb.transpose(C)
    assert Ct.row_ptr is None and Ct.format == tgb.SparseFormat.CSCONLY
    assert tgb.transpose(Ct).format == tgb.SparseFormat.CSRONLY


@pytest.mark.parametrize("mxvmode", [0, 1, 2])
@pytest.mark.parametrize("graph", [CHESAPEAKE, "rmat:10:16"],
                         ids=["chesapeake", "rmat10"])
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_verifies_on_the_cpu(driver, graph, mxvmode, capsys):
    """Each driver's main() with --device cpu under each --mxvmode prints
    its CORRECT line and the summary row and returns 0 (gbfs with
    run_bfs.sh's flags)."""
    module, correct = DRIVERS[driver]
    argv = [graph, "--device", "cpu", "--mxvmode", str(mxvmode),
            "--niter", "2"]
    if driver == "gbfs":
        argv += ["--timing", "0", "--earlyexit", "1", "--struconly", "1",
                 "--opreuse", "1"]
    if driver == "gdiameter":
        argv += ["--source_start", "0", "--source_end", "3"]
    assert module.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert _verified(out, correct)
    assert out[-2] == "cpu, warmup, tight, GTEPS"
    assert len(out[-1].split(", ")) == 4


def test_diameter_driver_prints_the_jax_answer(capsys):
    """gdiameter over sources [0, 10) of chesapeake prints the JAX
    diameter and its source."""
    from graphblast_tpu.algorithms import diameter as jax_diameter

    J = jcli.load_graph(_parse(jcli, [CHESAPEAKE]))
    d, s = jax_diameter(J, 0, 10)
    assert gdiameter.main([CHESAPEAKE, "--device", "cpu", "--source_start",
                           "0", "--source_end", "10", "--niter", "1"]) == 0
    assert f"DIAMETER: {int(d)} (source {int(s)}) CORRECT" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_returns_1_on_a_wrong_golden(driver, monkeypatch, capsys):
    """A golden that disagrees makes the driver print INCORRECT and return
    1 (for gcc, gmis and the colourings, whose golden is a property
    verifier, a verifier that says no)."""
    from graphblast_tpu_torch.algorithms import reference

    module, _ = DRIVERS[driver]
    verifier = {"gcc": "verify_cc", "gmis": "verify_mis", "ggc": "verify_gc",
                "ggc_cusparse": "verify_gc"}.get(driver)
    if verifier:
        monkeypatch.setattr(reference, verifier, lambda A, got: False)
    elif driver == "gpr":
        good = reference.pr_cpu
        monkeypatch.setattr(reference, "pr_cpu",
                            lambda *a, **kw: good(*a, **kw) + 1.0)
    elif driver == "gtc":
        good = reference.tc_cpu
        monkeypatch.setattr(reference, "tc_cpu", lambda L: good(L) + 1)
    elif driver == "gsssp":
        good = reference.sssp_cpu
        monkeypatch.setattr(reference, "sssp_cpu",
                            lambda A, s: good(A, s) + 1.0)
    elif driver == "glgc":
        good = reference.lgc_cpu
        monkeypatch.setattr(reference, "lgc_cpu",
                            lambda *a, **kw: good(*a, **kw) + 1.0)
    else:
        good = reference.bfs_cpu
        monkeypatch.setattr(reference, "bfs_cpu",
                            lambda A, s: good(A, s) + 1)
    assert module.main([CHESAPEAKE, "--device", "cpu", "--niter", "1"]) == 1
    assert "INCORRECT" in capsys.readouterr().out


def test_driver_raises_without_a_card():
    """The drivers run on cuda unless --device says otherwise, and raise
    where there is no card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        gbfs.main([CHESAPEAKE, "--niter", "1"])


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    """--profile <dir> writes the benchmark loop's torch.profiler trace as
    <dir>/trace.json, holding the annotated span."""
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        with profiling.annotate("graphblast-span"):
            torch.ones(4).sum()
    assert "graphblast-span" in (out / "trace.json").read_text()
    assert gbfs.main([CHESAPEAKE, "--device", "cpu", "--niter", "1",
                      "--profile", str(tmp_path / "run")]) == 0
    assert (tmp_path / "run" / "trace.json").stat().st_size > 0
    with profiling.trace(""):
        pass


def test_memory_flag_reads_the_card_only(capsys):
    """--memory (the reference's memory_ flag) prints the card's memory
    after the runs; with --device cpu there is no card, and the driver
    prints what it prints without the flag."""
    argv = [CHESAPEAKE, "--device", "cpu", "--niter", "1"]
    assert gbfs.main(argv) == 0
    plain = capsys.readouterr().out
    assert gbfs.main(argv + ["--memory"]) == 0
    out = capsys.readouterr().out
    assert "memory:" not in out
    assert re.sub(r"[\d.]+", "#", out) == re.sub(r"[\d.]+", "#", plain)


def test_verify_helpers_report_mismatches(capsys):
    assert verify_list(np.arange(4), np.arange(4), "X")
    assert not verify_list(np.arange(4), np.array([0, 1, 5, 3]), "X")
    assert "first mismatch at [2]" in capsys.readouterr().out
    assert isinstance(tcli.build_parser("g"), argparse.ArgumentParser)


def test_glgc_prints_the_jax_answer(capsys):
    """glgc's --alpha defaults to 0.15, as the JAX driver's does, and its
    result on chesapeake from source 3 equals the JAX lgc's within the
    JAX test's bar (rtol 1e-3, atol 1e-7)."""
    from graphblast_tpu.algorithms import lgc as jax_lgc

    got = {}
    real = glgc.run_driver

    def spy(name, description, run_fn, *rest, **kw):
        def run(A, args, desc):
            got["alpha"] = args.alpha
            got["p"] = run_fn(A, args, desc)
            return got["p"]
        return real(name, description, run, *rest, **kw)

    glgc.run_driver = spy
    try:
        assert glgc.main([CHESAPEAKE, "--device", "cpu", "--source", "3",
                          "--niter", "1"]) == 0
    finally:
        glgc.run_driver = real
    assert got["alpha"] == 0.15
    assert "LGC: CORRECT" in capsys.readouterr().out
    J = jcli.load_graph(_parse(jcli, [CHESAPEAKE]))
    want = np.asarray(jax_lgc(J, 3, alpha=0.15, eps=1e-6).to_numpy())
    np.testing.assert_allclose(got["p"].numpy(), want, rtol=1e-3, atol=1e-7)


def test_gtc_prints_the_jax_count(capsys):
    """gtc runs tril once and tc(L) on it: on chesapeake it prints the JAX
    tc's count of tril(A), equal to the golden, and exits 0."""
    from graphblast_tpu import tril as jax_tril
    from graphblast_tpu.algorithms import tc as jax_tc

    J = jcli.load_graph(_parse(jcli, [CHESAPEAKE]))
    want = int(jax_tc(jax_tril(J)))
    assert gtc.main([CHESAPEAKE, "--device", "cpu", "--niter", "2"]) == 0
    out = capsys.readouterr().out
    assert f"TC: ntris={want} golden={want} CORRECT" in out


def test_ggc_takes_its_algorithm_and_colour_bound(capsys):
    """ggc --gcalgo jp|mis|is and --maxcolors reach gc; each colouring
    verifies, and ggc_cusparse colours as ggc --gcalgo cusparse (the IS
    colouring) does."""
    counts = {}
    for algo in ("is", "mis", "jp", "cusparse"):
        assert ggc.main([CHESAPEAKE, "--device", "cpu", "--niter", "1",
                         "--gcalgo", algo, "--maxcolors", "64"]) == 0
        counts[algo] = re.search(r"colors=(\d+)",
                                 capsys.readouterr().out).group(1)
    assert ggc_cusparse.main([CHESAPEAKE, "--device", "cpu", "--niter",
                              "1"]) == 0
    assert f"GC[CORRECT]: colors={counts['cusparse']}" in (
        capsys.readouterr().out)
    assert counts["cusparse"] == counts["is"]
