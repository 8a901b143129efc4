"""SSSP relaxations a call, over the traced calls: the program's
"gb.sssp.iter" spans inside each call, one a relaxation, averaged; read
only where each call's count equals the relaxations its loop returned.
Layer: algorithm loop (algorithms/sssp.py)."""
from gbench.sssp_spans import call_iterations


def read(run, st):
    per_call = call_iterations(run, st)
    if not per_call:
        return None
    return sum(len(c) for c in per_call) / len(per_call)
