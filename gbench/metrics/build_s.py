"""Seconds of Matrix.from_device_coo on the canonical arrays, timed by the
benchmark's span in set-up (the device drained at both ends). Layer:
containers (matrix.py)."""


def read(run, st):
    return run.spans.get("build_s")
