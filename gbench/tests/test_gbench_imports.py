"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the references load nothing of the port."""
import ast
import json
import os
import subprocess
import sys

from gbench import device, harness

GBENCH = os.path.join(harness.ROOT, "gbench")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for d, _, files in os.walk(GBENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f))}
                assert not tops & set(device.FORBIDDEN), (f, tops)


def test_forbidden_names_compare_whole():
    assert device.forbidden_loaded({"graphblast_tpu_torch.matrix": 1,
                                    "jaxtyping": 1}) == []
    assert device.forbidden_loaded({"graphblast_tpu.ops": 1, "jax": 1}) == [
        "graphblast_tpu", "jax"]


def _run(code: str, root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, GBENCH_TEST_ROOT=root))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root):
    """A whole run of each cell, traced and not, in a fresh process."""
    code = (
        "import json, os, sys\n"
        "from gbench import device, harness\n"
        "root = os.environ['GBENCH_TEST_ROOT']\n"
        "for w in ('kron25-bfs', 'urand25-bfs', 'kron25-pr'):\n"
        "    for t in (0, 1):\n"
        "        harness.run_cell(w, 3, 0.1, t, 'cpu', root=root)\n"
        "print(json.dumps({'found': device.forbidden_loaded(),\n"
        "                  'port': 'graphblast_tpu_torch' in sys.modules}))\n")
    out = _run(code, tiny_root)
    assert out == {"found": [], "port": True}


def test_references_load_nothing_of_the_port(tiny_root):
    code = (
        "import json, sys\n"
        "import gbench.graphs, gbench.roofline\n"
        "import gbench.reference.bfs, gbench.reference.pr, gbench.control\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
        "                        & {'graphblast_tpu_torch', 'graphblast_tpu',\n"
        "                           'jax', 'jaxlib', 'flax'})))\n")
    assert _run(code, tiny_root) == []
