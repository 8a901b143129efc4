"""Dimension checks at every operation entry point (counterpart of
graphblast_tpu/dimension.py; reference: graphblas/dimension.hpp:13-114
checkDimRowCol/RowRow/ColCol/RowSize/ColSize/SizeSize).

Each check reads the operands' shapes only and raises DimensionException
(a ValueError, the GrB_DIMENSION_MISMATCH analog, types.hpp:33) with the
operand names in the message, before any device work is launched.
"""
from __future__ import annotations


class DimensionException(ValueError):
    """GrB_DIMENSION_MISMATCH (reference: types.hpp:33)."""


def _fail(op: str, detail: str):
    raise DimensionException(f"{op}: dimension mismatch — {detail}")


def check_row_col(A, B, op: str):
    """A.ncols == B.nrows (checkDimRowCol — mxm inner dim)."""
    if A.ncols != B.nrows:
        _fail(op, f"A is {A.shape}, B is {B.shape} (A.ncols != B.nrows)")


def check_row_row(A, B, op: str):
    """A.nrows == B.nrows (checkDimRowRow)."""
    if A.nrows != B.nrows:
        _fail(op, f"A.nrows={A.nrows} vs B.nrows={B.nrows}")


def check_col_col(A, B, op: str):
    """A.ncols == B.ncols (checkDimColCol)."""
    if A.ncols != B.ncols:
        _fail(op, f"A.ncols={A.ncols} vs B.ncols={B.ncols}")


def check_row_size(A, u, op: str, name: str = "u"):
    """A.nrows == u.n (checkDimRowSize — vxm input / mxv mask)."""
    if u is not None and A.nrows != u.n:
        _fail(op, f"A.nrows={A.nrows} vs {name}.n={u.n}")


def check_col_size(A, u, op: str, name: str = "u"):
    """A.ncols == u.n (checkDimColSize — mxv input / vxm mask)."""
    if u is not None and A.ncols != u.n:
        _fail(op, f"A.ncols={A.ncols} vs {name}.n={u.n}")


def check_size_size(u, v, op: str, names: str = "u/v"):
    """u.n == v.n (checkDimSizeSize — eWise / masks / assign)."""
    if u is not None and v is not None and u.n != v.n:
        _fail(op, f"{names}: {u.n} vs {v.n}")
