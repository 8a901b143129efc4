"""K6, the gather: y[i] = x[clamp(idx[i], 0, n - 1)] for a 1-D float32 or
int32 table and int32 indices. `ops/gather_dispatch.take` routes every such
gather of the plan-less pull here: x at the column ids, the segment tails,
the prefix sums at the row boundaries.

Replaces graphblast_tpu/ops/pallas/gather.py:_gather_kernel (run by
gather_1d) and _gather_small_kernel (run by gather_1d_small). Their 128-lane
table sweeps, per-chunk range pruning and small-table full sweep work
around the TPU's 128-entry lane gather, and the JAX `take` picks between
them and XLA's gather by a TPU cost model. On Hopper a thread reads its
indices and then its entries: one kernel (csrc/gather.cu, four queries a
thread, or a grid-stride loop of one query a thread where idx or y is not
16-byte aligned) serves both entries at every size. Indices are clamped
into the table, as the JAX package's off-TPU `x[idx]` does, so the kernel
equals `gather_1d_plain`. Memory-bound: 4·(2·m + min(n, m)) bytes per call,
61.9 MB for the gather of x at the CSC row ids at RMAT scale 18, 18.5 µs at
the H100's 3.35 TB/s. At the row boundaries (m = n + 1) the card works
about 2 µs a call, so the wrapper's host path sets the time: it checks
with no torch.device object and launches through `_build.launcher`.

`gather_1d` launches the kernel for CUDA tensors and counts each launch in
`gather_1d.launches`, and those at ascending indices (`sorted=True`: the
segment tails and row boundaries) in `gather_1d.sorted_launches` too; for
CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LAUNCH = _build.launcher(
    "gather",
    {"gb_gather": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p], ctypes.c_int),
     "gb_gather_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_gather", "gb_gather_error_string")

DTYPES = (torch.float32, torch.int32)


def gather_1d_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index with the clamped indices."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def _check(x: torch.Tensor, idx: torch.Tensor):
    if x.dim() != 1 or x.dtype not in DTYPES:
        raise TypeError(f"x must be a 1-D float32 or int32 tensor, not "
                        f"{x.dim()}-D {x.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("idx must be a 1-D int32 tensor")
    # device indices (-1 off the card), not torch.device objects, on the
    # launch path
    dev = x.get_device()
    if dev != idx.get_device() or dev < 0 and x.device != idx.device:
        raise ValueError(f"x on {x.device}, idx on {idx.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    if x.shape[0] == 0 and idx.shape[0]:
        raise ValueError(f"{idx.shape[0]} queries into an empty table")


def gather_1d(x: torch.Tensor, idx: torch.Tensor,
              sorted: bool = False) -> torch.Tensor:
    """y[i] = x[clamp(idx[i], 0, n - 1)], of x's dtype, shape (m,). CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, or raise. `sorted` (the caller's indices ascend) does
    not change the launch; it only files the launch under the sorted
    count."""
    _check(x, idx)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return gather_1d_plain(x, idx)
        raise ValueError(f"no gather for device {x.device}")
    m = idx.shape[0]
    y = x.new_empty(m)
    if m == 0:      # a zero-size grid is an invalid launch
        return y
    _LAUNCH(x.get_device(), x.data_ptr(), idx.data_ptr(), y.data_ptr(), m,
            x.shape[0])
    gather_1d.launches += 1
    if sorted:
        gather_1d.sorted_launches += 1
    return y


gather_1d.launches = 0
gather_1d.sorted_launches = 0
