"""Core type definitions (counterpart of graphblast_tpu/types.py).

Indices are int32 (the reference's `Index`, graphblas/types.hpp:18); values
default to float32. Errors raise Python exceptions.
"""
from __future__ import annotations

import enum

import torch

# The GraphBLAS `Index` type (reference: graphblas/types.hpp:18).
INDEX_DTYPE = torch.int32

# Edge arrays are padded to a TILE multiple, as in the JAX package, so that a
# Matrix carried across from JAX keeps its exact leaves. Kernels never read
# past ptr[n]; the padding only keeps the two packages' arrays comparable.
TILE = 1024


class Info(enum.Enum):
    """Status codes (reference: types.hpp:28-42), named for API parity.
    Errors raise exceptions here: DIMENSION_MISMATCH is
    dimension.DimensionException (a ValueError), INVALID_VALUE and
    INVALID_INDEX are ValueError; SUCCESS is a call that returns."""

    SUCCESS = 0
    NO_VALUE = 1
    UNINITIALIZED_OBJECT = 2
    NULL_POINTER = 3
    INVALID_VALUE = 4
    INVALID_INDEX = 5
    DOMAIN_MISMATCH = 6
    DIMENSION_MISMATCH = 7
    OUTPUT_NOT_EMPTY = 8
    OUT_OF_MEMORY = 9
    INSUFFICIENT_SPACE = 10
    INVALID_OBJECT = 11
    INDEX_OUT_OF_BOUNDS = 12
    PANIC = 13
    NOT_IMPLEMENTED = 14


class Storage(enum.Enum):
    """Vector/Matrix storage state (reference: graphblas/types.hpp:21-23)."""

    UNKNOWN = 0
    SPARSE = 1
    DENSE = 2


class SparseFormat(enum.Enum):
    """Sparse matrix storage format (reference: backend/cuda/types.hpp:7-11).

    CSRCSC keeps both copies (direction-optimized mxv/vxm needs both);
    CSRONLY/CSCONLY force a single direction (GRB_SPARSE_MATRIX_FORMAT).
    """

    CSRCSC = 0
    CSRONLY = 1
    CSCONLY = 2


class LoadBalanceMode(enum.Enum):
    """Push-kernel load-balance strategy (reference: backend/cuda/types.hpp:13-17)."""

    SIMPLE = 0
    TWC = 1
    MERGE = 2


class Direction(enum.Enum):
    """mxv/vxm execution mode (reference: types.hpp:62-64 GrB_PUSHPULL etc.)."""

    PUSHPULL = 0  # auto: frontier-density heuristic picks per iteration
    PUSHONLY = 1  # sparse-frontier SpMSpV
    PULLONLY = 2  # dense-frontier SpMV


def dtype_max(dtype: torch.dtype):
    """numeric_limits<T>::max() (the Minimum monoid identity). FLT_MAX, not
    +inf, as the reference uses (sssp.hpp:26)."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).max)
    return int(torch.iinfo(dtype).max)


def dtype_lowest(dtype: torch.dtype):
    """numeric_limits<T>::min() (the Greater monoid identity). For floats the
    smallest positive normal, not -inf: the reference's C++ quirk
    (stddef.hpp:166)."""
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).tiny)
    return int(torch.iinfo(dtype).min)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
