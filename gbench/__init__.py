"""The benchmark of graphblast_tpu_torch on an NVIDIA card.

`python3 -m gbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once and prints one JSON line
(README.md). Configurations, traffic mixes, entries, generators and
per-layer metric readers are files found by name (`harness.py`); the
yardstick (graph generation, references, byte counts, peaks, the trace's
reduction) lives here, beside the program and apart from it.
"""
