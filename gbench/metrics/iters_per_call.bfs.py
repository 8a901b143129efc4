"""BFS iterations a call, over the traced calls: the deepest level of each
returned vector (the loop runs until an iteration finds nothing, so as
many iterations as levels). Layer: algorithm loop (algorithms/bfs.py)."""
from gbench.readers import call_depths


def read(run, st):
    depths = call_depths(st)
    return sum(depths) / len(depths) if depths else None
