"""K2 and K3, the value pull: y[i] = Σ val[e]·x[ind[e]] over the edges of
row i of the pull orientation, fp32 products and fp32 accumulation (the
Plus-Times SpMV of PageRank). A unit-valued plan (`unit_vals`) sums x over
the row, so on a 0/1 frontier (y > 0) is the LogicalOrAnd pull.

Replaces graphblast_tpu/ops/pallas/bilinear.py:_kernel / _kernel_packed
(K2, run by spmv_bilinear on plans from build_plan / plan_for) and
_kernel_f32_dma (K3, run by spmv_bilinear_dma on plans from
build_plan_f32dma). The two TPU layouts exist because x and y must fit VMEM
below a size gate (bilinear_available) and are windowed by DMA above it;
their tiles, bit-packed local ids, lane sweeps, one-hot matrix-unit scatter,
hi/lo split and pack=K columns all work around VMEM and the matrix unit.
On Hopper the plan is the pull orientation's CSR (CSC for vxm) with its
values and a row schedule (`build_schedule`: rows binned by length, long
rows cut into chunks, a thread-block cluster a row), and one kernel
(csrc/value_pull.cu) serves every size. It is memory-bound: 8·nnz + 4·(n_out + 1) + 4·n_in + 4·n_out bytes
per call, 64.0 MB at RMAT scale 18, 19.1 µs at the H100's 3.35 TB/s.

`spmv_value_pull` launches the kernel for CUDA tensors and counts each
launch in `spmv_value_pull.launches`; for CPU tensors it runs the plain
PyTorch version, `spmv_value_pull_plain`, which the tests and the chip check
compare the kernel with.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...types import INDEX_DTYPE
from . import _build

_LAUNCH = _build.launcher(
    "value_pull",
    {"gb_value_pull": ([ctypes.c_void_p] * 9, ctypes.c_int),
     "gb_value_pull_error_string": ([ctypes.c_int], ctypes.c_char_p)},
    "gb_value_pull", "gb_value_pull_error_string")

# T, tuned on an H100 at RMAT scale 18 by a sweep over 2048 .. 16384
# (PERF.md): a row of more edges is cut into CLUSTER chunks, one block's
# work each, the blocks of one thread-block cluster
LONG_ROW = 8192
CLUSTER = 8     # kCluster of csrc/value_pull.cu
# bins, in the order of the schedule: long rows, medium rows (one warp a
# row), then rows of at most 32, 16, 8 and 4 edges (a group of that many
# lanes a row); the kernel's rows a 256-thread block takes in bins 1-5
N_BINS = 6
ROWS_A_BLOCK = (None, 8, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class RowSchedule:
    """How the kernel spreads one sparsity structure over the card, built
    by `build_schedule` on ptr's device. `perm` (int32, n_out) is the rows
    stably sorted by bin, bin b at perm[bin_begin[b]:bin_begin[b + 1]];
    the k-th long row (bin 0) is cut into CLUSTER chunks of about equal
    length, chunk j from edge chunk_beg[CLUSTER * k + j] to the next
    chunk's start (the row's end for the last). Blocks block_begin[b] ..
    block_begin[b+1] - 1 serve bin b, one chunk or ROWS_A_BLOCK[b] rows
    each. Nothing in it changes after it is built, and the kernel keeps no
    scratch of its own."""

    perm: torch.Tensor
    bin_begin: tuple
    chunk_beg: torch.Tensor
    block_begin: tuple

    def __post_init__(self):
        meta = (ctypes.c_int * (2 * N_BINS + 2))(
            *self.block_begin, *self.bin_begin)
        # the kernel's arguments after y, as the launch passes them
        args = (self.perm.data_ptr(), self.chunk_beg.data_ptr(),
                ctypes.addressof(meta))
        object.__setattr__(self, "_meta", meta)
        object.__setattr__(self, "args", args)

    @property
    def bin_rows(self) -> tuple:
        return tuple(self.bin_begin[b + 1] - self.bin_begin[b]
                     for b in range(N_BINS))

    @property
    def n_chunks(self) -> int:
        return self.chunk_beg.shape[0]

    @property
    def blocks(self) -> int:
        return self.block_begin[-1]


def build_schedule(ptr: torch.Tensor) -> RowSchedule:
    """The row schedule of a CSR's row pointers (int32, n_out + 1), with
    torch ops on ptr's device and one read of six sizes to the host. A
    row of L edges goes to bin 0 when L > LONG_ROW, bin 1 when 32 < L <=
    LONG_ROW, else to bin 2, 3, 4 or 5 when L is at most 32, 16, 8 or 4."""
    dev = ptr.device
    length = (ptr[1:] - ptr[:-1]).long()
    bins = (N_BINS - 1) - sum((length > t).long()
                              for t in (4, 8, 16, 32, LONG_ROW))
    perm = torch.argsort(bins, stable=True)
    rows = torch.bincount(bins, minlength=N_BINS).tolist()
    long_rows = perm[:rows[0]]
    beg = ptr[long_rows].long()
    n = length[long_rows]
    step = (n + CLUSTER - 1) // CLUSTER
    chunk_beg = beg[:, None] + torch.minimum(
        torch.arange(CLUSTER, device=dev) * step[:, None], n[:, None])
    blocks = [CLUSTER * rows[0]] + [-(-rows[b] // ROWS_A_BLOCK[b])
                                    for b in range(1, N_BINS)]
    return RowSchedule(
        perm=perm.to(INDEX_DTYPE),
        bin_begin=tuple(np.cumsum([0] + rows).tolist()),
        chunk_beg=chunk_beg.reshape(-1).to(INDEX_DTYPE),
        block_begin=tuple(np.cumsum([0] + blocks).tolist()))


@dataclasses.dataclass(frozen=True)
class ValuePlan:
    """The pull orientation's CSR on the device: ptr (n_out+1,) int32, ind
    int32 with at least ptr[n_out] entries, all < n_in, and val float32 of
    the same reach, or None when every edge has the value 1 (`unit_vals`);
    and its RowSchedule, which a launch on the card needs (`build_plan`
    gives every plan on the card one)."""

    n_out: int
    n_in: int
    ptr: torch.Tensor
    ind: torch.Tensor
    val: Optional[torch.Tensor]
    sched: Optional[RowSchedule] = None

    @property
    def unit_vals(self) -> bool:
        return self.val is None


def check_csr(ptr: torch.Tensor, ind: torch.Tensor,
              val: Optional[torch.Tensor], n_out: int, n_in: int) -> tuple:
    """Check a pull-orientation CSR, which the value and monoid kernels
    trust: int32 ptr (n_out+1,) non-decreasing from 0, ind with at least
    ptr[n_out] entries, all < n_in, and val (None: all ones) of the same
    reach. Returns (ptr, ind, val) contiguous, val as float32."""
    if ptr.dtype != INDEX_DTYPE or ind.dtype != INDEX_DTYPE:
        raise TypeError("plan index arrays must be int32")
    if ptr.device != ind.device or ptr.dim() != 1 or ind.dim() != 1:
        raise ValueError("ptr and ind must be 1-D tensors on one device")
    if ptr.shape[0] != n_out + 1:
        raise ValueError(f"ptr has {ptr.shape[0]} entries, want {n_out + 1}")
    m = int(ptr[-1])
    if m > ind.shape[0] or int(ptr[0]) != 0:
        raise ValueError("ptr does not index into ind")
    if n_out and not bool((ptr[1:] >= ptr[:-1]).all()):
        raise ValueError("ptr is not non-decreasing")
    if m and not 0 <= int(ind[:m].min()) <= int(ind[:m].max()) < n_in:
        raise ValueError(f"column ids outside [0, {n_in})")
    if val is not None:
        if val.dim() != 1 or val.shape[0] < m or val.device != ptr.device:
            raise ValueError(f"val must be 1-D on {ptr.device} with at "
                             f"least {m} entries")
        val = val.to(torch.float32).contiguous()
    return ptr.contiguous(), ind.contiguous(), val


def build_plan(ptr: torch.Tensor, ind: torch.Tensor,
               val: Optional[torch.Tensor], n_out: int, n_in: int,
               sched: Optional[RowSchedule] = None) -> ValuePlan:
    """Check a CSR and wrap it as a plan (the kernel trusts these bounds).
    `val=None` means all ones; other values are kept as float32. A plan on
    the card gets `sched`, which must be ptr's schedule, or a new one."""
    ptr, ind, val = check_csr(ptr, ind, val, n_out, n_in)
    if sched is None and ptr.is_cuda:
        sched = build_schedule(ptr)
    if sched is not None and (sched.perm.shape[0] != n_out
                              or sched.perm.device != ptr.device):
        raise ValueError(f"the schedule orders {sched.perm.shape[0]} rows "
                         f"on {sched.perm.device}, the plan has {n_out} on "
                         f"{ptr.device}")
    return ValuePlan(n_out, n_in, ptr, ind, val, sched)


def plan_for(A, transpose: bool = False,
             host_val: Optional[np.ndarray] = None,
             ones: bool = False) -> Optional[ValuePlan]:
    """Plan for one pull orientation of Matrix `A`: the CSR for the mxv pull
    (y = A·x), the CSC for the vxm pull (transpose=True, y = Aᵀ·x). Cached
    in A._plans under "csr"/"csc" (+ "/ones"); None when A lacks that
    orientation. `host_val` (NumPy, in the orientation's edge order)
    replaces the stored values, as PageRank's α/outdegree scaling does, and
    such a plan is never cached. `ones=True` gives a unit-valued plan. On
    the card every plan of an orientation shares one RowSchedule, cached
    under "csr/schedule"/"csc/schedule", so a host_val plan builds none."""
    n_out, n_in, ptr, ind, val = A.pull_csr(transpose)
    if ptr is None:
        return None
    orient = "csc" if transpose else "csr"
    key = orient + ("/ones" if ones else "")
    if host_val is None and key in A._plans:
        return A._plans[key]
    if ones:
        val = None
    elif host_val is not None:
        val = torch.from_numpy(np.ascontiguousarray(host_val)).to(ptr.device)
    sched = None
    if ptr.is_cuda:
        sched = A._plans.get(orient + "/schedule")
        if sched is None:
            sched = A._plans[orient + "/schedule"] = build_schedule(ptr)
    plan = build_plan(ptr, ind, val, n_out, n_in, sched)
    if host_val is None:
        A._plans[key] = plan
    return plan


def spmv_value_pull_plain(plan: ValuePlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: expand row ids, index_add_ the float64
    products per row, cast to float32."""
    ptr = plan.ptr.long()
    m = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(plan.n_out, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=m)
    prod = x[plan.ind[:m].long()].double()
    if plan.val is not None:
        prod = prod * plan.val[:m].double()
    y = torch.zeros(plan.n_out, dtype=torch.float64, device=ptr.device)
    return y.index_add_(0, rows, prod).to(torch.float32)


def check_x(plan, x: torch.Tensor):
    """x as a kernel over `plan` takes it: contiguous 1-D float32 of
    length plan.n_in, on the plan's device."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError("x must be a 1-D float32 tensor")
    if x.shape[0] != plan.n_in:
        raise ValueError(f"x has {x.shape[0]} entries, the plan reads "
                         f"{plan.n_in}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.ptr.device:
        raise ValueError(f"x on {x.device}, plan on {plan.ptr.device}")


def spmv_value_pull(plan: ValuePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A·x over Plus-Times for the plan's orientation (float32,
    (n_out,)). CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream, or raise (a plan with no schedule too)."""
    check_x(plan, x)
    if x.device.type == "cpu":
        return spmv_value_pull_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"no value pull for device {x.device}")
    y = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    if plan.n_out == 0:      # a zero-size grid is an invalid launch
        return y
    if plan.sched is None:
        raise ValueError("a plan on the card needs its RowSchedule "
                         "(build_plan or plan_for gives it one)")
    _LAUNCH(x.get_device(), plan.ptr.data_ptr(), plan.ind.data_ptr(),
            None if plan.val is None else plan.val.data_ptr(), x.data_ptr(),
            y.data_ptr(), *plan.sched.args)
    spmv_value_pull.launches += 1
    return y


spmv_value_pull.launches = 0
