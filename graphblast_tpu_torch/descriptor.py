"""Descriptor: per-call configuration (counterpart of
graphblast_tpu/descriptor.py; reference: graphblas/descriptor.hpp:17-60).

A frozen dataclass; `replace`/`toggle_*` return new descriptors.
"""
from __future__ import annotations

import dataclasses

from .types import Direction, LoadBalanceMode


@dataclasses.dataclass(frozen=True)
class Descriptor:
    # --- mask handling (reference: types.hpp:44-55 GrB_MASK field) ---
    mask_scmp: bool = False        # structural complement (GrB_SCMP)
    structure_only: bool = False   # struconly (descriptor.hpp:50): mask and
    #                                 frontier are {0,1} structure

    # --- output / input modifiers ---
    output_replace: bool = False   # GrB_REPLACE
    transpose_inp0: bool = False   # GrB_INP0 ∘ GrB_TRAN
    transpose_inp1: bool = False   # GrB_INP1 ∘ GrB_TRAN

    # --- mxv/vxm direction optimization (reference: vector.hpp:292-323) ---
    mxv_mode: Direction = Direction.PUSHPULL
    switchpoint: float = 0.01      # frontier-density threshold
    memusage: float = 1.0          # push edge-workspace factor

    # --- push/pull kernel knobs (reference: descriptor.hpp:50-60) ---
    # earlyexit, opreuse, endbit and fusedmask are accepted for flag parity
    # with the reference and change nothing here: the masked bitmap pull
    # (K1's masked entry) always stops each open row at its first frontier
    # neighbour, both frontier images stay live, no radix sort runs and the
    # mask is always applied in the same pass as the pull.
    earlyexit: bool = False
    opreuse: bool = False
    endbit: bool = False
    fusedmask: bool = True
    sort_push: bool = None         # default from `load_balance`
    load_balance: LoadBalanceMode = None  # default from GRB_LOAD_BALANCE_MODE

    # --- algorithm loop controls (reference: descriptor.hpp:207-287) ---
    max_niter: int = 10000
    timing: int = 0                # 0: off, 1: per-iter CSV, 2: verbose CSV
    debug: bool = False
    dirinfo: bool = False          # announce push/pull switches
    seed: int = None               # default from GRB_SEED

    # --- execution (reference: the GrB_BACKEND toggle, types.hpp:69-70,
    # for apply with stateful host functors, apply.hpp:34-42, 102-111) ---
    backend: str = "device"        # "device" (torch ops on the tensors'
    #                                 device) | "cpu" (a host-functor loop,
    #                                 read by apply and apply_matrix)

    def __post_init__(self):
        if self.load_balance is None:
            from .config import default_load_balance

            object.__setattr__(self, "load_balance", default_load_balance())
        if self.sort_push is None:
            object.__setattr__(self, "sort_push",
                               self.load_balance != LoadBalanceMode.SIMPLE)
        if self.seed is None:
            from .config import default_seed

            object.__setattr__(self, "seed", default_seed())

    def replace(self, **kw) -> "Descriptor":
        return dataclasses.replace(self, **kw)

    def toggle_mask(self) -> "Descriptor":
        """Scoped-complement idiom (reference: bfs.hpp:67-70)."""
        return self.replace(mask_scmp=not self.mask_scmp)

    def toggle_inp0(self) -> "Descriptor":
        return self.replace(transpose_inp0=not self.transpose_inp0)

    def toggle_inp1(self) -> "Descriptor":
        return self.replace(transpose_inp1=not self.transpose_inp1)


DEFAULT = Descriptor()

# Tuned BFS flags (reference: run_bfs.sh:8-24); mxv_mode stays PUSHPULL.
BFS_TUNED = Descriptor(structure_only=True, earlyexit=True, opreuse=True)
