"""The card a run uses, as the result line names it, and the check that
the run loaded nothing of JAX or of the JAX package."""
from __future__ import annotations

import subprocess
import sys

# top-level module names a run of the port may not load; compared whole,
# since the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "graphblast_tpu")


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names of loaded modules that are in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def power_limit_w(index: int = 0):
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device) -> dict:
    """The result line's `device`, but for memory_peak_bytes and the power
    limit, which the harness reads after the window, out of set-up."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
