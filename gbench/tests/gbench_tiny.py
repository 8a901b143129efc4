"""A copy of the benchmark cut to a scale the CPU runs in a second."""
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_SCALE = 10


def make_root(path, scale: int = TINY_SCALE) -> str:
    """A copy of the benchmark under `path` with every configuration at
    `scale`, for runs on the CPU."""
    root = str(path)
    shutil.copytree(os.path.join(REPO, "gbench"), os.path.join(root, "gbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        cfg["scale"] = scale
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
