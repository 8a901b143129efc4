"""One run of one cell: set-up, the measured window, the readings, the check.

Everything that belongs to one configuration, traffic mix, entry, graph
generator or per-layer metric is a file found by its name under the root's
gbench/ folder:

    BENCHMARK.json                 the cells and metrics
    <config's "file">              a configuration: its generator and sizes
    gbench/generators/<name>.py    generate(cfg, gen, device) -> Graph
    gbench/traffic/<name>.json     a traffic mix: its entry and parameters
    gbench/entries/<name>.py       the program's calls under that mix
    gbench/metrics/<name>.py       read(run, state) -> number or None

An entry module has setup(run) -> state, call(run, state, k) -> the k-th
call's output, keep(run, state, k, out), free(run, state), end_to_end(run,
state) -> {metric: value}, checks(run, state) -> ({name: (value, limit)},
failed calls), and, for a traced run, optionally trace_on(run, state).
Where run.control is set, its setup puts the reference's control in the
program's place. An entry or a metric module that reads a launch counter of
the program declares it in COUNTERS, {key: (module, function, attribute)};
the window's count of each is in run.launches[key].
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from typing import Optional

import torch

from gbench import device as devinfo
from gbench import roofline
from gbench import trace as tracemod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "graphblast_tpu_torch"     # the system under test
BUILD = PROGRAM + ".ops.kernels._build"   # its nvcc builds, timed apart
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Run:
    """What a run hands its entry and its readers."""
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    control: bool = False
    graph: object = None
    spans: dict = dataclasses.field(default_factory=dict)
    latencies: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)
    trace_summary: object = None
    peaks: Optional[dict] = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a set-up step on the host clock, the device drained at both
        ends, into spans[name] (seconds)."""
        self.sync()
        t = time.perf_counter()
        yield
        self.sync()
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{name!r} is not a name of the benchmark")
    return name


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(root: str, kind: str, name: str):
    """root/gbench/<kind>/<name>.py, loaded by its path."""
    path = os.path.join(root, "gbench", kind, check_name(name) + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"gbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules and sys.modules[key].__file__ == path:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: str = ROOT) -> tuple:
    """(cell, configuration file's contents, traffic file's contents) of
    the named cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(
        root, "gbench", "traffic", check_name(cell["traffic"]) + ".json"))
    return cell, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics in an
    untraced run, its per-layer ones in a traced run."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


class Sample:
    """A uniform sample of `size` of the window's calls, drawn from `rng`
    as the calls come (reservoir sampling), whatever their number:
    `kept` maps each sampled call to its output."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.kept, self.seen = size, rng, {}, 0

    def offer(self, k, out):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = out
            return
        slot = self.rng.randrange(self.seen)
        if slot < self.size:
            del self.kept[sorted(self.kept)[slot]]
            self.kept[k] = out


def draw_graph(generator, config: dict, device):
    """The configuration's graph, drawn on `device` from its fixed
    graph_seed, as GAP draws its graphs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["graph_seed"]))
    return generator.generate(config, gen, device)


def draw_roots(g, traffic: dict) -> list:
    """The traffic's roots: `roots` vertices of at least root_min_degree
    edges, without repeats, drawn from its fixed roots_seed, as GAP picks
    its trial sources."""
    gen = torch.Generator(device=g.deg.device)
    gen.manual_seed(int(traffic["roots_seed"]))
    cand = torch.nonzero(g.deg >= int(traffic["root_min_degree"])).flatten()
    pick = torch.randperm(cand.shape[0], generator=gen,
                          device=cand.device)[:int(traffic["roots"])]
    return cand[pick].tolist()


def declared_counters(modules) -> dict:
    """The launch counters the given entry and metric modules declare in
    their COUNTERS, {key: (module, function, attribute)}."""
    out = {}
    for mod in modules:
        for key, where in getattr(mod, "COUNTERS", {}).items():
            if out.setdefault(key, tuple(where)) != tuple(where):
                raise ValueError(f"counter {key!r} is declared as both "
                                 f"{out[key]} and {tuple(where)}")
    return out


def _counters(declared: dict) -> dict:
    out = {}
    for key, (mod, fn, attr) in declared.items():
        holder = getattr(importlib.import_module(mod), fn)
        if hasattr(holder, attr):
            out[key] = getattr(holder, attr)
    return out


@contextlib.contextmanager
def _compile_span(run: Run):
    """Time the program's kernel builds (nvcc, where a library is not
    built yet) into spans["compile_s"], a part of set-up."""
    build = importlib.import_module(BUILD)
    inner = build.build

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            run.spans["compile_s"] = (run.spans.get("compile_s", 0.0)
                                      + time.perf_counter() - t)

    build.build = timed
    try:
        yield
    finally:
        build.build = inner


def _window(run: Run, entry, state, calls: Optional[int], counters: dict):
    """The measured window: a closed loop of the entry's calls, one caller,
    in whole cycles of the traffic (state.cycle calls, 1 by default) until
    `run.seconds` have passed (or `calls` calls, in a traced run), so that
    every window does the same work for its length. Each call is timed from
    its start to a synchronize after it returns."""
    cycle = getattr(state, "cycle", 1)
    mark = torch.profiler.record_function if run.trace else (
        lambda name: contextlib.nullcontext())
    before = _counters(counters)
    with mark(tracemod.WINDOW):
        start = time.perf_counter()
        k = 0
        while (k < calls) if calls is not None else (
                k % cycle or time.perf_counter() - start < run.seconds):
            with mark(tracemod.CALL):
                t = time.perf_counter()
                out = entry.call(run, state, k)
                run.sync()
                run.latencies.append(time.perf_counter() - t)
            entry.keep(run, state, k, out)
            del out
            k += 1
        run.sync()
        run.window_s = time.perf_counter() - start
    after = _counters(counters)
    run.launches = {key: after[key] - before.get(key, 0) for key in after}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: str = ROOT, bench: Optional[dict] = None,
             t0: Optional[float] = None, control: bool = False) -> dict:
    """One run of `workload`: the result line's object, with "checks" last
    (each number compared and its limit). `device` may be the CPU for the
    tests, where the program runs its plain versions; the command refuses
    it. With `control`, the entry's control stands in the program's place
    for the traffic's "sample" calls, and the check has to fail it."""
    t0 = time.perf_counter() if t0 is None else t0
    importlib.import_module(PROGRAM)      # fail before any work without it
    device = torch.device(device)
    bench = load_bench(root) if bench is None else bench
    _, config, traffic = resolve(bench, workload, root)
    run = Run(traffic, int(seed), float(seconds), bool(trace), device, t0,
              control=bool(control))
    with _compile_span(run):
        return _run(run, bench, workload, config, root)


def _run(run: Run, bench: dict, workload: str, config: dict,
         root: str) -> dict:
    traffic, device, t0 = run.traffic, run.device, run.t0
    info = devinfo.describe(device)
    run.spans["start_s"] = time.perf_counter() - t0   # imports, the card
    run.peaks = roofline.peaks_of(info["kind"])
    generator = load_module(root, "generators", config["generator"])
    with run.span("generate_s"):
        run.graph = draw_graph(generator, config, device)
    entry = load_module(root, "entries", traffic["entry"])
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in metrics_of(bench, workload, True)}
    counters = declared_counters([entry, *readers.values()])
    state = entry.setup(run)
    deg = run.graph.deg
    if not run.control:
        # the program holds its own copy; the window keeps only the
        # degrees, and the graph is drawn again from its graph_seed for the
        # readings
        run.graph = dataclasses.replace(run.graph, rows=None, cols=None,
                                        ptr=None)
    run.sync()
    setup_s = time.perf_counter() - t0

    prof = None
    if run.trace:
        if hasattr(entry, "trace_on"):
            entry.trace_on(run, state)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _window(run, entry, state, int(traffic["trace_calls"]), counters)
    else:
        _window(run, entry, state,
                int(traffic["sample"]) if run.control else None, counters)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.free(run, state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if run.graph.rows is None:
        with run.span("regenerate_s"):
            run.graph = draw_graph(generator, config, device)
        if not torch.equal(run.graph.deg, deg):
            raise RuntimeError("the graph drawn again from its seed differs")

    metrics, breakdown = {}, None
    t_read = time.perf_counter()
    if run.trace:
        run.trace_summary = tracemod.reduce(prof) if prof is not None else None
        del prof
        for m in metrics_of(bench, workload, True):
            value = readers[m["name"]].read(run, state)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        ts = run.trace_summary
        if ts is not None and device.type == "cuda":
            info["busy_s"] = ts.busy_s()
            info["window_s"] = ts.window_s
            breakdown = {"device_ops": ts.device_ops(),
                         "idle_gaps": ts.idle_gaps()}
    else:
        values = dict(entry.end_to_end(run, state), setup_s=setup_s)
        for m in metrics_of(bench, workload, False):
            if m["name"] not in values:
                raise KeyError(f"entry {traffic['entry']!r} reports no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    run.spans["read_s"] = time.perf_counter() - t_read
    with run.span("check_s"):
        checks, failed = entry.checks(run, state)
    correct = failed == 0 and all(
        v <= limit for v, limit in checks.values())
    if device.type == "cuda":
        info["power_limit_w"] = devinfo.power_limit_w(device.index or 0)
    info["memory_peak_bytes"] = int(peak)
    out = {"correct": bool(correct), "attempted": len(run.latencies),
           "failed": int(failed), "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["spans"] = dict(run.spans, setup_s=setup_s, n=run.graph.n,
                        m=run.graph.m)
    out["latencies_ms"] = [round(t * 1e3, 3) for t in run.latencies]
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return out
