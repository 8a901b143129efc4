"""P, the bitmap push: the structure-only push of a frontier under a
duplicate-insensitive ⊕ (LogicalOr, Max), which BFS runs. It returns what
`spmspv_push_sparse` returns for that push: y (n_out,), 1 at each new vertex
and 0 elsewhere; sind (n_out,) int32, the new ids ascending at the front and
n_out in every pad slot; no values; nv, a 0-d int32 tensor.

Replaces no TPU kernel: the JAX package pushes in jnp over a workspace of a
fixed tier of lanes, sorted by destination (graphblast_tpu/ops/spmspv.py),
and `ops/spmspv.py` ports that lowering. Under such a ⊕ a destination only
has to be marked once, so the sort buys nothing (GraphBLAST's struconly
push, spmspv_inner.hpp:133-134, 228-251, 292-299): csrc/bitmap_push.cu
packs the mask into one bit a vertex, expands the frontier's edges in blocks
of EDGES_PER_BLOCK (each block finds its first frontier slot by a search of
the degrees' scan), marks each destination that passes the mask in a bitmap
with atomicOr, and compacts the bitmap into y and sind. No workspace of
tier lanes, no sort, no K6. The frontier's degrees and their scan are torch
ops over its snvals slots. Memory-bound: 4·(deg_total + 3·n_out) bytes, the
column ids read once and the mask, y and sind once each.

`spmspv_push_bitmap` launches the kernel for CUDA tensors and counts each
call in `spmspv_push_bitmap.launches`; for CPU tensors it runs
`spmspv_push_bitmap_plain`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_LAUNCH = _build.launcher(
    "bitmap_push",
    {"gb_bitmap_push": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong] + [ctypes.c_void_p] * 6,
                        ctypes.c_int),
     "gb_bitmap_push_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_bitmap_push", "gb_bitmap_push_error_string")

# kEdges and kTileWords · 32 of csrc/bitmap_push.cu
EDGES_PER_BLOCK = 4096
_TILE_VERTICES = 65536


def push_lanes(deg_total: int) -> int:
    """The lanes the expansion launch covers: whole blocks of
    EDGES_PER_BLOCK edges over the degree total."""
    return -(-deg_total // EDGES_PER_BLOCK) * EDGES_PER_BLOCK


def spmspv_push_bitmap_plain(ptr: torch.Tensor, ind: torch.Tensor,
                             f_ind: torch.Tensor, snvals: int,
                             deg_total: int,
                             mask_dense: Optional[torch.Tensor],
                             mask_scmp: bool, n_out: int,
                             out_dtype=torch.float32):
    """Plain PyTorch version: every edge of the frontier's rows, its
    destination marked where the mask passes, the marks compacted. Runs on
    any device (the card times it beside the kernel)."""
    dev = ptr.device
    fi = f_ind[:snvals].long()
    start = ptr[fi].long()
    deg = ptr[fi + 1].long() - start
    slot = torch.repeat_interleave(torch.arange(snvals, device=dev), deg,
                                   output_size=deg_total)
    first = torch.cumsum(deg, 0) - deg
    edge = start[slot] + torch.arange(deg_total, device=dev) - first[slot]
    dst = ind[edge].long()
    hit = torch.zeros(n_out + 1, dtype=torch.bool, device=dev)
    hit[torch.where((dst >= 0) & (dst < n_out), dst, n_out)] = True
    hit = hit[:n_out]
    if mask_dense is not None:
        nz = mask_dense != 0
        hit &= ~nz if mask_scmp else nz
    ids = torch.nonzero(hit).flatten().to(torch.int32)
    sind = torch.full((n_out,), n_out, dtype=torch.int32, device=dev)
    sind[:ids.shape[0]] = ids
    return (hit.to(out_dtype), sind, None,
            torch.tensor(ids.shape[0], dtype=torch.int32, device=dev))


def _check(ptr, ind, f_ind, snvals, deg_total, mask_dense, n_out):
    for name, t in (("ptr", ptr), ("ind", ind), ("f_ind", f_ind)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if t.device != ptr.device:
            raise ValueError(f"{name} on {t.device}, ptr on {ptr.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask_dense is not None and (mask_dense.shape != (n_out,)
                                   or mask_dense.device != ptr.device):
        raise ValueError(f"the mask must be ({n_out},) on {ptr.device}")
    if not 0 <= snvals <= f_ind.shape[0]:
        raise ValueError(f"snvals {snvals} outside the frontier's "
                         f"{f_ind.shape[0]} slots")
    if not 0 <= deg_total < 1 << 31 or not 0 <= n_out < 1 << 31:
        raise ValueError("the push holds fewer than 2^31 edges and vertices")


def spmspv_push_bitmap(ptr: torch.Tensor, ind: torch.Tensor,
                       f_ind: torch.Tensor, snvals: int, deg_total: int,
                       mask_dense: Optional[torch.Tensor], mask_scmp: bool,
                       n_out: int, out_dtype=torch.float32):
    """(y, sind, None, nv): the push of the frontier f_ind[:snvals] (ids of
    the rows of (ptr, ind), the push orientation) whose degree total is
    `deg_total`, a host int, under mask_pass(mask_dense, mask_scmp). CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, or raise."""
    _check(ptr, ind, f_ind, snvals, deg_total, mask_dense, n_out)
    if ptr.device.type == "cpu":
        return spmspv_push_bitmap_plain(ptr, ind, f_ind, snvals, deg_total,
                                        mask_dense, mask_scmp, n_out,
                                        out_dtype)
    if ptr.device.type != "cuda":
        raise ValueError(f"no bitmap push for device {ptr.device}")
    dev = ptr.device
    y = torch.empty(n_out, dtype=torch.float32, device=dev)
    sind = torch.empty(n_out, dtype=torch.int32, device=dev)
    nv = torch.empty((), dtype=torch.int32, device=dev)
    if n_out == 0:      # a zero-size grid is an invalid launch
        return y.to(out_dtype), sind, None, nv.zero_()
    incl = delta = None
    if snvals and deg_total:
        fi = f_ind[:snvals]
        start = ptr.index_select(0, fi)
        deg = ptr.index_select(0, fi + 1) - start
        incl = torch.cumsum(deg, 0, dtype=torch.int32)
        # edge e of slot s is ind[e + delta[s]]
        delta = start - incl + deg
    mask = None
    if mask_dense is not None:
        mask = (mask_dense if mask_dense.dtype == torch.float32
                else (mask_dense != 0).to(torch.float32)).contiguous()
    n_words = (n_out + 31) // 32
    scratch = torch.empty(2 * n_words - (-n_out // _TILE_VERTICES),
                          dtype=torch.int32, device=dev)
    _LAUNCH(ptr.get_device(), None if mask is None else mask.data_ptr(),
            int(mask_scmp), n_out,
            None if incl is None else incl.data_ptr(),
            None if delta is None else delta.data_ptr(), snvals, deg_total,
            ind.data_ptr(), scratch.data_ptr(), y.data_ptr(),
            sind.data_ptr(), nv.data_ptr())
    spmspv_push_bitmap.launches += 1
    if out_dtype != torch.float32:
        y = y.to(out_dtype)
    return y, sind, None, nv


spmspv_push_bitmap.launches = 0
