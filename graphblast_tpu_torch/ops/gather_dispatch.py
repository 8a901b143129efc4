"""Gather dispatch (counterpart of graphblast_tpu/ops/gather_dispatch.py).

`take(x, idx)` is y[i] = x[idx[i]]. A 1-D float32 or int32 table goes to
the gather kernel K6 (`ops/kernels/gather.py`), whatever its size and the
order of the indices: the JAX `take`'s gates (m ≥ 8192, table rows ≤ 128 or
≤ 2048, sorted or not) are the TPU's cost model, and one Hopper kernel
serves every case. Every other dtype and rank indexes plainly, as the JAX
`take` does for them. On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from .kernels.gather import DTYPES, gather_1d


def take(x: torch.Tensor, idx: torch.Tensor,
         sorted: bool = False) -> torch.Tensor:
    """y[i] = x[idx[i]], indices clamped into the table as the JAX package's
    off-TPU gather does. One kernel serves sorted and unsorted indices:
    `sorted` only splits the kernel's launch count by call-site class."""
    last = max(x.shape[0] - 1, 0)
    if x.dim() == 1 and idx.dim() == 1 and x.dtype in DTYPES:
        if idx.dtype != torch.int32:
            # clamped first, so the int32 cast is exact for any table that
            # int32 indices can address
            idx = idx.clamp(0, last).to(torch.int32)
        return gather_1d(x.contiguous(), idx.contiguous(), sorted=sorted)
    return x[idx.clamp(0, last).long()]
