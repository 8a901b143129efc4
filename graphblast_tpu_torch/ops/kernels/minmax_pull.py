"""S, the min/max row fold of the plan-less pull: y[i] = ⊕ over the edges e
of row i of val[e] ⊗ x[clamp(ind[e])], and the semiring's identity for an
empty row, in x's dtype (int32 or float32), for the catalogue's five
semirings whose ⊕ is min or max. It computes what `spmv_pull` computed for
them as `segment_reduce_csr(semiring.mul(val.to(x.dtype), take(x, ind)),
ptr, ⊕, n)`: MIS and graph colouring pull MaximumMultiplies over the int32
CSC, CC at n ≥ 2^24 MinimumSelectSecond over the CSR.

Replaces no Pallas kernel: the JAX package computes this as plain jnp
(graphblast_tpu/ops/segops.py:35 segmented_scan under segment_reduce_csr),
a Hillis–Steele flag scan over the whole edge array after a gather of x.
On Hopper one launch (csrc/minmax_pull.cu) reads each edge once, gathers
x, applies ⊗ and folds ⊕ per row through the orientation's RowSchedule
(row_schedule.py, shared with the value pull, K4 and K1). Each fold starts
at ⊕'s true neutral (INT_MIN / INT_MAX, ∓inf), not at the semiring's
identity (MaximumMonoid's is 0), and only an empty row gets the identity;
products are not clamped, int32 products wrap and min/max propagate NaN,
as the torch ops do. min and max are exact in any order, so the kernel
equals `spmv_minmax_pull_plain` (floats up to the sign of zero).
Memory-bound: 8·nnz + 4·(n_out + 1) + 4·n_in + 4·n_out bytes a call, 4·nnz
less for select-second, which reads no values: 64.0 MB and 33.6 MB at RMAT
scale 18, 19.1 µs and 10.0 µs at the H100's 3.35 TB/s.

`spmv_minmax_pull` launches the kernel for CUDA tensors, with the
orientation's schedule (`schedule_for`), and counts each launch in
`spmv_minmax_pull.launches`; for CPU tensors it runs the plain version,
which needs no schedule.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...types import INDEX_DTYPE
from . import _build
from .row_schedule import RowSchedule

_LAUNCH = _build.launcher(
    "minmax_pull",
    {"gb_minmax_pull": ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                        + [ctypes.c_int] * 3
                        + [ctypes.c_uint, ctypes.c_void_p], ctypes.c_int),
     "gb_minmax_pull_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_minmax_pull", "gb_minmax_pull_error_string")

# semiring name -> (⊕, ⊗): the catalogue's semirings with a min/max ⊕
SEMIRING_MAP = {
    "MinimumPlus": ("min", "plus"),
    "MinimumMultiplies": ("min", "mul"),
    "MinimumSelectSecond": ("min", "second"),
    "MinimumNotEqualTo": ("min", "neq"),
    "MaximumMultiplies": ("max", "mul"),
}
DTYPES = (torch.int32, torch.float32)
# the kernel's codes for ⊕ and ⊗ (csrc/minmax_pull.cu)
_ADD_CODE = {"min": 0, "max": 1}
_MUL_CODE = {"plus": 0, "mul": 1, "second": 2, "neq": 3}


def minmax_supported(semiring, dtype: torch.dtype) -> bool:
    """Whether S computes `semiring`'s pull on a frontier of `dtype`."""
    return semiring.name in SEMIRING_MAP and dtype in DTYPES


@functools.lru_cache(maxsize=None)
def _identity_bits(semiring, dtype: torch.dtype) -> int:
    """The semiring's identity in `dtype`, as the 32 bits the kernel takes."""
    ident = semiring.identity(dtype).reshape(1)
    return int(ident.view(torch.int32)) & 0xFFFFFFFF


def _check(ptr, ind, val, x, semiring, n_out: int) -> str:
    """Raise on what the kernel does not take; returns ⊗."""
    if not minmax_supported(semiring, x.dtype):
        raise ValueError(f"no min/max row fold for {semiring.name} on "
                         f"{x.dtype}; it computes {sorted(SEMIRING_MAP)} on "
                         "int32 and float32")
    mul = SEMIRING_MAP[semiring.name][1]
    if ptr.dtype != INDEX_DTYPE or ind.dtype != INDEX_DTYPE:
        raise TypeError("ptr and ind must be int32")
    if ptr.dim() != 1 or ind.dim() != 1 or x.dim() != 1:
        raise ValueError("ptr, ind and x must be 1-D")
    if ptr.shape[0] != n_out + 1:
        raise ValueError(f"ptr has {ptr.shape[0]} entries, want {n_out + 1}")
    if val is None:
        if mul != "second":
            raise ValueError(f"{semiring.name} reads edge values")
    elif val.dim() != 1 or val.shape[0] < ind.shape[0]:
        raise ValueError("val must be 1-D with an entry for each of ind's")
    dev = x.get_device()
    if (ptr.get_device() != dev or ind.get_device() != dev
            or val is not None and val.get_device() != dev):
        raise ValueError(f"ptr, ind, val and x must be on one device "
                         f"(x on {x.device})")
    if not (ptr.is_contiguous() and ind.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ptr, ind and x must be contiguous")
    if x.shape[0] == 0 and ind.shape[0]:
        raise ValueError(f"{ind.shape[0]} column ids into an empty x")
    return mul


def spmv_minmax_pull_plain(ptr: torch.Tensor, ind: torch.Tensor,
                           val: Optional[torch.Tensor], x: torch.Tensor,
                           semiring, n_out: int) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype: gather x at the clamped column
    ids, ⊗ with the values cast to x's dtype, then scatter_reduce amin/amax
    with include_self=False into y filled with the identity, so that only
    empty rows keep it."""
    mul = _check(ptr, ind, val, x, semiring, n_out)
    add = SEMIRING_MAP[semiring.name][0]
    p64 = ptr.long()
    m = int(p64[-1])
    rows = torch.repeat_interleave(torch.arange(n_out, device=ptr.device),
                                   p64[1:] - p64[:-1], output_size=m)
    p = x[ind[:m].long().clamp(0, max(x.shape[0] - 1, 0))]
    if mul != "second":
        p = semiring.mul(val[:m].to(x.dtype), p)
    y = semiring.identity(x.dtype).to(x.device).expand(n_out).clone()
    return y.scatter_reduce_(0, rows, p, "a" + add, include_self=False)


def spmv_minmax_pull(ptr: torch.Tensor, ind: torch.Tensor,
                     val: Optional[torch.Tensor], x: torch.Tensor, semiring,
                     n_out: int, *,
                     sched: Optional[RowSchedule] = None) -> torch.Tensor:
    """The min/max pull of `semiring` (a SEMIRING_MAP entry) over a CSR,
    (n_out,) of x's dtype. `val` (None only for select-second) is cast to
    x's dtype. CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream with `sched`, the schedule of ptr
    (`schedule_for` of the Matrix's orientation), or raise (without one
    too)."""
    if x.device.type == "cpu":
        return spmv_minmax_pull_plain(ptr, ind, val, x, semiring, n_out)
    mul = _check(ptr, ind, val, x, semiring, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"no min/max row fold for device {x.device}")
    if sched is None:
        raise ValueError("a min/max pull on the card needs the row schedule "
                         "of its orientation (row_schedule.schedule_for)")
    if sched.perm.shape[0] != n_out or sched.perm.get_device() != \
            x.get_device():
        raise ValueError(f"the schedule orders {sched.perm.shape[0]} rows on "
                         f"{sched.perm.device}, the pull has {n_out} on "
                         f"{x.device}")
    if mul == "second":
        val = None
    elif val.dtype != x.dtype or not val.is_contiguous():
        val = val.to(x.dtype).contiguous()
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    if n_out == 0:      # a zero-size grid is an invalid launch
        return y
    add = SEMIRING_MAP[semiring.name][0]
    _LAUNCH(x.get_device(), ptr.data_ptr(), ind.data_ptr(),
            None if val is None else val.data_ptr(), x.data_ptr(),
            y.data_ptr(), *sched.args, x.shape[0], _ADD_CODE[add],
            _MUL_CODE[mul], int(x.dtype == torch.float32),
            _identity_bits(semiring, x.dtype))
    spmv_minmax_pull.launches += 1
    return y


spmv_minmax_pull.launches = 0
