"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry, generator and per-layer metric resolves to its file by
name; names, units and the other fields keep to the allowed characters;
and a new cell comes in by adding files and entries alone."""
import json
import os
import re

import pytest

from gbench import harness
from gbench_tiny import make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.load_bench()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) < 65536


def test_configs_resolve():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("gbench/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        harness.load_module(harness.ROOT, "generators", cfg["generator"])
        assert all(NAME.match(k) and k in cfg["reduced"] for k in c["reduced"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)


def test_cells_resolve():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, _, traffic = harness.resolve(BENCH, w["name"])
        harness.load_module(harness.ROOT, "entries", traffic["entry"])
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_metrics_resolve():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        assert m["moves"] in e2e
        harness.load_module(harness.ROOT, "metrics", m["name"])
        # each cell a per-layer metric lists reports the metric it moves
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:   # setup_s, one more end-to-end, one per-layer
        assert len(harness.metrics_of(BENCH, cell, False)) >= 2
        assert harness.metrics_of(BENCH, cell, True)


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and cell are a new JSON file each
    and new entries in BENCHMARK.json; they run, and no file that was there
    changes."""
    root = make_root(tmp_path)

    def snapshot():
        out = {}
        for d, _, fs in os.walk(os.path.join(root, "gbench")):
            for f in fs:
                if "__pycache__" not in d:
                    with open(os.path.join(d, f), "rb") as fh:
                        out[os.path.join(d, f)] = fh.read()
        return out

    before = snapshot()
    cfg = harness.load_json(os.path.join(root, "gbench/configs/kron25.json"))
    cfg.update(name="kron8", scale=8, edge_factor=8)
    with open(os.path.join(root, "gbench/configs/kron8.json"), "w") as f:
        json.dump(cfg, f)
    traffic = harness.load_json(
        os.path.join(root, "gbench/traffic/graph500_bfs.json"))
    traffic.update(roots=8, sample=3, trace_calls=8)
    with open(os.path.join(root, "gbench/traffic/bfs8.json"), "w") as f:
        json.dump(traffic, f)
    bench = harness.load_bench(root)
    bench["configs"].append({"name": "kron8", "source": "a smaller kron",
                             "file": "gbench/configs/kron8.json",
                             "reduced": ["scale", "edge_factor"],
                             "why": "a test"})
    bench["workloads"].append({"name": "kron8-bfs8", "config": "kron8",
                               "traffic": "bfs8", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kron25-bfs" in m.get("workloads", []):
            m["workloads"].append("kron8-bfs8")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = harness.run_cell("kron8-bfs8", 1, 0.2, False, "cpu", root=root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"bfs_gteps", "bfs_p95_ms", "setup_s"}
    out = harness.run_cell("kron8-bfs8", 1, 0.2, True, "cpu", root=root)
    assert out["correct"] and out["attempted"] == 8
    after = snapshot()
    assert all(after[p] == data for p, data in before.items())


def test_a_counter_metric_is_added_by_files_alone(tmp_path):
    """A per-layer metric on a launch counter the harness did not read
    before is one new file, which declares the counter, and a new entry in
    BENCHMARK.json; the traced run reports it, and no file that was there
    changes."""
    root = make_root(tmp_path)
    before = {p: open(p, "rb").read() for p in _files(root)}
    with open(os.path.join(root, "gbench/metrics/gathers.bfs.py"), "w") as f:
        f.write('COUNTERS = {"gather": ("graphblast_tpu_torch.ops.kernels.'
                'gather", "gather_1d", "launches")}\n\n\n'
                'def read(run, st):\n'
                '    return run.launches["gather"] / len(run.latencies)\n')
    bench = harness.load_bench(root)
    bench["per_layer"].append({"name": "gathers.bfs", "unit": "launches",
                               "better": "lower", "source": "program_counter",
                               "layer": "push", "moves": "bfs_gteps",
                               "workloads": ["kron25-bfs"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = harness.run_cell("kron25-bfs", 1, 0.2, True, "cpu", root=root)
    assert out["correct"] and "gathers.bfs" in out["metrics"]
    assert all(open(p, "rb").read() == data for p, data in before.items()
               if not p.endswith("BENCHMARK.json"))


def _files(root):
    return [os.path.join(d, f)
            for d, _, fs in os.walk(os.path.join(root, "gbench"))
            if "__pycache__" not in d for f in fs]


def test_unknown_names_are_refused(tiny_root):
    with pytest.raises(KeyError):
        harness.resolve(BENCH, "no-such-cell")
    with pytest.raises(ValueError):
        harness.load_module(tiny_root, "metrics", "../run")
