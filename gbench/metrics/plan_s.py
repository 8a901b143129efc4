"""Seconds of the plans and row schedules the window's entry needs (BFS:
bfs_pull_plan; PageRank: prepare_pr_matrix and the value plan), timed by
the benchmark's span in set-up. Layer: plans."""


def read(run, st):
    return run.spans.get("plan_s")
