"""Result verification helpers, VERIFY_LIST / VERIFY_LIST_FLOAT equivalents
(counterpart of graphblast_tpu/utils/verify.py; reference:
test/test.hpp:60-114: the first mismatches with context, the error count,
'CORRECT')."""
from __future__ import annotations

import numpy as np


def _report(errors, got, want, label):
    if len(errors) == 0:
        print(f"{label}: CORRECT")
        return True
    print(f"{label}: INCORRECT ({len(errors)} errors)")
    for i in errors[:5]:
        lo, hi = max(0, i - 2), min(len(got), i + 3)
        print(f"  first mismatch at [{i}]: got {got[i]} want {want[i]} "
              f"(context got{got[lo:hi]} want{want[lo:hi]})")
    return False


def verify_list(got, want, label: str = "VERIFY") -> bool:
    """Exact elementwise check (reference: BOOST_ASSERT_LIST
    test.hpp:39-57). `got` and `want` are array-likes on the host."""
    got = np.asarray(got)
    want = np.asarray(want)
    errors = np.nonzero(got != want)[0]
    return _report(errors, got, want, label)


def verify_list_float(got, want, label: str = "VERIFY",
                      tol: float = 1e-3) -> bool:
    """Float check with the reference's 1e-3 relative tolerance
    (test.hpp:7-17)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    denom = np.maximum(np.abs(want), 1.0)
    errors = np.nonzero(np.abs(got - want) / denom > tol)[0]
    return _report(errors, got, want, label)
