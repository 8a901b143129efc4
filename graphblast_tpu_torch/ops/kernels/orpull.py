"""K5, the or-pull prefix count: csum[e] = Σ_{e' ≤ e} bit(col_ind[e']) as
int32, with bit(c) = (words[c>>5] >> (c&31)) & 1 for a frontier packed by
`bitmap_pull.pack_bitmap`, and 0 for a column c ≥ 32·n_words. The
structure-only LogicalOrAnd `spmv_pull` fetches csum at row_ptr − 1 and
differences the boundaries: a row is reached when its count grew.

Replaces graphblast_tpu/ops/pallas/orpull.py:_kernel (run by
orpull_bit_csum). That kernel streams col_ind through one TPU core in grid
order, sweeps the VMEM bitmap with lane gathers and carries the prefix sum
across grid steps in a scalar; its `orpull_available` VMEM gate has no
counterpart here. On Hopper the carry is a single-pass scan with decoupled
look-back, written by hand (csrc/orpull_csum.cu): one launch over tiles of
8,192 edges, 16 to each of a block's 512 threads, each block taking the next tile id from a counter,
publishing its tile's count and looking back over its predecessors' for
the prefix. The counter and the tiles' status words are scratch of the
call, allocated here and zeroed on the call's stream by the C entry, so
nothing is kept between calls. Integer arithmetic, so the kernel equals
`orpull_bit_csum_plain`. Memory-bound: 4·(2·m + n_words) bytes per call,
60.9 MB over the CSC at RMAT scale 18, 18.2 µs at the H100's 3.35 TB/s;
col_ind is read once.

`orpull_bit_csum` launches the kernel for CUDA tensors and counts each call
that launches it in `orpull_bit_csum.launches`; for CPU tensors it runs the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LAUNCH = _build.launcher(
    "orpull_csum",
    {"gb_orpull_csum": ([ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_void_p],
                        ctypes.c_int),
     "gb_orpull_csum_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_orpull_csum", "gb_orpull_csum_error_string")

# edges a tile: kTile of csrc/orpull_csum.cu, which sizes the scratch
_TILE = 8192


def orpull_bit_csum_plain(words: torch.Tensor,
                          col_ind: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather each edge's frontier bit, then an int32
    cumsum."""
    c = col_ind.long()
    inside = (c >= 0) & (c < 32 * words.shape[0])
    if words.shape[0]:
        w = words[(c >> 5).clamp(0, words.shape[0] - 1)].long()
        bit = ((w >> (c & 31)) & 1) * inside
    else:
        bit = torch.zeros_like(c)
    return torch.cumsum(bit, 0, dtype=torch.int32)


def _check(words: torch.Tensor, col_ind: torch.Tensor):
    if words.dim() != 1 or words.dtype != torch.int32:
        raise TypeError("words must be a 1-D int32 tensor")
    if col_ind.dim() != 1 or col_ind.dtype != torch.int32:
        raise TypeError("col_ind must be a 1-D int32 tensor")
    if words.device != col_ind.device:
        raise ValueError(f"words on {words.device}, col_ind on "
                         f"{col_ind.device}")
    if not (words.is_contiguous() and col_ind.is_contiguous()):
        raise ValueError("words and col_ind must be contiguous")
    if col_ind.shape[0] >= 1 << 31:
        raise ValueError("an int32 prefix count holds fewer than 2^31 edges")


def orpull_bit_csum(words: torch.Tensor,
                    col_ind: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix count of frontier bits over col_ind (int32,
    (m,)). CPU tensors run the plain version; CUDA tensors launch the kernel
    on the current stream, or raise."""
    _check(words, col_ind)
    if words.device.type == "cpu":
        return orpull_bit_csum_plain(words, col_ind)
    if words.device.type != "cuda":
        raise ValueError(f"no or-pull prefix count for device {words.device}")
    m = col_ind.shape[0]
    csum = torch.empty(m, dtype=torch.int32, device=words.device)
    if m == 0:      # a zero-size grid is an invalid launch
        return csum
    # the tile counter, then one status word a tile; zeroed by the C entry
    scratch = torch.empty((m + _TILE - 1) // _TILE + 1, dtype=torch.int64,
                          device=words.device)
    _LAUNCH(words.get_device(), words.data_ptr(), words.shape[0],
            col_ind.data_ptr(), csum.data_ptr(), m, scratch.data_ptr())
    orpull_bit_csum.launches += 1
    return csum


orpull_bit_csum.launches = 0
