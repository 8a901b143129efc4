"""Direction-optimized mxv/vxm dispatch (counterpart of
graphblast_tpu/ops/dispatch.py; reference: backend/cuda/operations.hpp:82-327
and the direction heuristic, backend/cuda/vector.hpp:292-323).

Ported so far: the DualFrontier carry, the direction heuristic, and two
branches of `mxv_dual`:
  - PULLONLY (dispatch.py:255-296 of the JAX package): over a plan, the
    structure-only LogicalOrAnd pull over a bitmap plan (K1, fused BFS) or
    a unit-valued value plan, the PlusMultiplies pull over a value plan
    (K2/K3), and the min/max semirings of the monoid pull over a monoid
    plan (K4, SSSP); with no plan, `spmv_pull` over the pull orientation
    (K5 and K6 for stepped BFS, the row fold S for a min/max semiring, with
    the orientation's cached row schedule); and the `postprocess` epilogue;
  - PUSHONLY (dispatch.py:432-436): the push of `ops/spmspv.py` over the
    push orientation, in the eager protocol, with every gather on K6.
A Matrix that lacks one orientation runs the direction it has, as the
reference's one-sided formats do. PUSHPULL, the switch between the two, is
ROADMAP queue 1 item 5b, with the lazy dual-frontier protocol: it raises
NotImplementedError here rather than run another path.

The push's workspace is one of a few fixed sizes (tiers: edge_cap/64,
edge_cap/8, edge_cap, each rounded up to 1,024), as in the JAX package. JAX
picks the tier on the device with a cond ladder; here the degree total and
the frontier's count come to the host in one read per push, and the
smallest tier that holds both runs. Where JAX truncates a frontier whose
degree total exceeds edge_cap, the port raises ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..matrix import Matrix
from ..semiring import Semiring
from ..types import INDEX_DTYPE, Direction, round_up
from ..vector import dense_from_sparse, sparse_from_dense
from .kernels.bitmap_pull import BitmapPlan, pack_bitmap, spmv_bitmap_pull
from .kernels.minmax_pull import minmax_supported
from .kernels.monoid_pull import MonoidPlan, monoid_supported, spmv_monoid
from .kernels.row_schedule import schedule_for
from .kernels.value_pull import ValuePlan, spmv_value_pull
from .spmspv import spmspv_push, spmspv_push_sparse
from .spmv import mask_pass, spmv_pull

PUSHPULL_TODO = ("PUSHPULL, the switch between push and pull, is not ported "
                 "yet: ROADMAP queue 1 item 5b; run one direction with "
                 "mode=Direction.PUSHONLY or Direction.PULLONLY")


@dataclasses.dataclass(frozen=True)
class DualFrontier:
    """Frontier with both storage images and the direction preference.

    dense (n,), sind (cap,), sval (cap,) or None, snvals, ratio and
    use_sparse as tensors on the frontier's device. A pull-only loop keeps
    the sparse image stale: only push reads it.
    """

    n: int
    dense: torch.Tensor
    sind: torch.Tensor
    sval: Optional[torch.Tensor]
    snvals: torch.Tensor
    ratio: torch.Tensor       # previous nnz/n (hysteresis state)
    use_sparse: torch.Tensor  # bool: push preferred

    @staticmethod
    def from_dense(dense: torch.Tensor, identity,
                   prefer_sparse: bool = False) -> "DualFrontier":
        n = dense.shape[0]
        sind, sval, nv = sparse_from_dense(dense, identity)
        return DualFrontier(n, dense, sind, sval, nv, nv.float() / n,
                            torch.tensor(prefer_sparse, device=dense.device))

    @staticmethod
    def from_sparse(n: int, sind, sval, snvals, identity) -> "DualFrontier":
        """The frontier of the stored entries sind[:snvals] (values sval).
        Entries whose value is the identity are dropped and the rest keep
        their order at the front, so that both images hold one entry set:
        the push sizes its workspace from the dense image and expands the
        sparse one."""
        cap = sind.shape[0]
        keep = (torch.arange(cap, dtype=INDEX_DTYPE, device=sind.device)
                < snvals) & (sval != identity)
        spos = torch.where(keep, torch.cumsum(keep, 0, dtype=INDEX_DTYPE) - 1,
                           cap).long()
        kept_ind = torch.full((cap + 1,), n, dtype=INDEX_DTYPE,
                              device=sind.device)
        kept_ind[spos] = sind.to(INDEX_DTYPE)
        kept_val = torch.full((cap + 1,), identity, dtype=sval.dtype,
                              device=sval.device)
        kept_val[spos] = sval
        sind, sval = kept_ind[:cap], kept_val[:cap]
        snvals = keep.sum().to(INDEX_DTYPE)
        dense = dense_from_sparse(n, sind, sval, snvals, identity)
        return DualFrontier(n, dense, sind, sval, snvals,
                            snvals.float() / n,
                            torch.tensor(True, device=dense.device))


def update_direction(nv: torch.Tensor, n: int, prev_ratio, prev_sparse,
                     switchpoint: float, mode) -> tuple:
    """The convert() heuristic with hysteresis (reference:
    vector.hpp:292-323): sparse→dense when density > switchpoint and rising,
    dense→sparse when density ≤ switchpoint and falling. Returns
    (use_sparse, ratio)."""
    ratio = nv.float() / n
    # filled on the device: torch.tensor(..., device=) would copy from
    # the host and wait for the stream
    true = torch.ones((), dtype=torch.bool, device=nv.device)
    if mode == Direction.PUSHONLY:
        return true, ratio
    if mode == Direction.PULLONLY:
        return ~true, ratio
    rising = ratio >= prev_ratio
    use_sparse = torch.where(ratio > switchpoint,
                             torch.where(rising, ~true, prev_sparse),
                             torch.where(~rising, true, prev_sparse))
    return use_sparse, ratio


def _frontier_degree_total(push_ptr: torch.Tensor, f: DualFrontier,
                           identity) -> torch.Tensor:
    """Σ deg(frontier) from the dense image: the pointer differences where
    the frontier is not the identity, one reduction (a 0-d tensor). The
    dense and the push's rows share the input-vertex space in both
    orientations."""
    nn = f.dense.shape[0]
    deg = push_ptr[1: nn + 1] - push_ptr[:nn]
    return torch.where(f.dense != identity, deg, 0).sum()


def push_tiers(edge_cap: int, tier_divisors: tuple = (64, 8)) -> list:
    """The push workspace sizes, smallest first: edge_cap // div rounded up
    to 1,024 for each divisor, then edge_cap itself."""
    tiers = []
    for div in tier_divisors:
        c = min(edge_cap, max(round_up(edge_cap // div, 1024), 1024))
        if c < edge_cap and c not in tiers:
            tiers.append(c)
    return tiers + [edge_cap]


def pick_tier(tiers: list, deg_total: int, snvals: int) -> int:
    """The smallest tier that holds the degree total and the frontier's
    entries, as JAX's `fits` picks; the last tier takes the whole frontier
    whatever its count. Raises ValueError when the degree total exceeds
    the last tier, where JAX would drop edges."""
    for cap in tiers[:-1]:
        if deg_total <= cap and snvals <= cap:
            return cap
    if deg_total > tiers[-1]:
        raise ValueError(
            f"the frontier's degree total {deg_total} exceeds the push "
            f"workspace edge_cap={tiers[-1]}; raise the descriptor's "
            "memusage or pull")
    return tiers[-1]


def _push(A: Matrix, f: DualFrontier, semiring: Semiring, identity, n_out,
          push_csr, *, mask_dense, mask_scmp, structure_only, edge_cap,
          sort_push, tier_divisors, postprocess, postprocess_sparse):
    """The PUSHONLY branch: (y, sind, sval, nv) of one push over push_csr,
    the (ptr, ind, val) of A's CSR for vxm and of its CSC for mxv. One host
    read: the degree total and the frontier's count, which pick the
    tier."""
    push_ptr, push_ind, push_val = push_csr
    deg_total, snvals = torch.stack([
        _frontier_degree_total(push_ptr, f, identity).to(torch.int64),
        f.snvals.to(torch.int64)]).tolist()
    tiers = push_tiers(A.nnz_pad if edge_cap is None else edge_cap,
                       tier_divisors)
    cap = pick_tier(tiers, deg_total, snvals)
    # a lower tier holds the whole frontier (snvals <= cap): every stage of
    # the expansion then scales with the tier, not with n
    fs = f.sind[:cap] if cap < tiers[-1] else f.sind
    fcap = fs.shape[0]
    fv = f.sval[:fcap] if f.sval is not None else None
    with_vals = not structure_only
    if sort_push and (postprocess is None or postprocess_sparse is not None):
        # the MERGE push compacts the new frontier inside the workspace
        return spmspv_push_sparse(
            push_ptr, push_ind, push_val, fs, fv, f.snvals, semiring, n_out,
            cap, mask_dense, mask_scmp, structure_only,
            with_values=with_vals, postprocess_sparse=postprocess_sparse)
    y = spmspv_push(push_ptr, push_ind, push_val, fs, fv, f.snvals,
                    semiring, n_out, cap, mask_dense, mask_scmp,
                    structure_only, sort_push)
    # a dense-only producer re-sparsifies with the full-n sort (the
    # reference's streamCompact epilogue, vector.hpp:367-425)
    if postprocess is not None:
        y = postprocess(y)
    sind, sval, nv = sparse_from_dense(y, identity, with_values=with_vals)
    return y, sind, sval, nv


def mxv_dual(A: Matrix, f: DualFrontier, semiring: Semiring, identity, *,
             transpose: bool = False,
             mask_dense: Optional[torch.Tensor] = None,
             mask_scmp: bool = False, structure_only: bool = False,
             edge_cap: Optional[int] = None, sort_push: bool = True,
             switchpoint: float = 0.01, mode=None,
             postprocess: Optional[Callable] = None,
             postprocess_sparse: Optional[Callable] = None,
             tier_divisors: tuple = (64, 8), pull_plan=None):
    """One y = A ⊗ f (or fᵀ ⊗ A when transpose), returning a new
    DualFrontier and whether push ran (reference: operations.hpp:108-199
    vxm + convert()).

    `mode` PULLONLY pulls; PUSHONLY pushes; PUSHPULL (the default) raises
    NotImplementedError. A Matrix without the push orientation pulls and
    one without the pull orientation pushes, whatever `mode` says.

    Pull: `pull_plan` is None, for `spmv_pull` over the pull orientation's
    arrays (CSC for vxm, CSR for mxv) with any semiring, or a plan of that
    orientation: a BitmapPlan for the structure-only LogicalOrAnd pull, a
    ValuePlan for that pull (unit values only) or the PlusMultiplies pull,
    or a MonoidPlan for a min/max semiring of SEMIRING_MAP over a float32
    frontier. `postprocess(y)` runs after the mask and before the count of
    non-identity entries, as in the JAX PULLONLY branch. The pull keeps the
    sparse image stale: only push reads it.

    Push reads the frontier's sparse image (which must hold no
    identity-valued entry, see DualFrontier.from_sparse) and ignores
    `pull_plan`. Its workspace is the smallest of `push_tiers(edge_cap,
    tier_divisors)` that holds the frontier (edge_cap defaults to A's
    nnz_pad). `sort_push` picks the MERGE sort push, which builds the
    sparse image from its own sort, over the SIMPLE scatter push; a
    `postprocess` without its sparse twin `postprocess_sparse(keys, vals)`
    sends the push to the dense route and the full-n re-sparsification.
    The JAX signature's `lazy` comes with PUSHPULL."""
    mode = mode if mode is not None else Direction.PUSHPULL
    n_out, _, pull_ptr, pull_ind, pull_val = A.pull_csr(transpose)
    # push expands the input's adjacency: the other orientation
    push_csr = A.pull_csr(not transpose)[2:]
    if push_csr[0] is None:   # one-sided storage forces one direction
        mode = Direction.PULLONLY
    if pull_ptr is None:
        mode = Direction.PUSHONLY
    if mode == Direction.PUSHPULL:
        raise NotImplementedError(PUSHPULL_TODO)
    if mode == Direction.PUSHONLY:
        y, sind, sval, nv = _push(
            A, f, semiring, identity, n_out, push_csr,
            mask_dense=mask_dense, mask_scmp=mask_scmp,
            structure_only=structure_only, edge_cap=edge_cap,
            sort_push=sort_push, tier_divisors=tier_divisors,
            postprocess=postprocess, postprocess_sparse=postprocess_sparse)
        use_sparse, ratio = update_direction(nv, n_out, f.ratio, True,
                                             switchpoint, mode)
        return DualFrontier(n_out, y, sind, sval, nv, ratio, use_sparse), True
    or_pull = structure_only and semiring.name == "LogicalOrAnd"
    if isinstance(pull_plan, MonoidPlan):
        missing = [why for why, bad in (
            ("a pull that reads values (structure_only is set)",
             structure_only),
            (f"a semiring of SEMIRING_MAP ({semiring.name} is not)",
             not monoid_supported(semiring)),
            (f"a float32 frontier ({f.dense.dtype} given)",
             f.dense.dtype != torch.float32)) if bad]
        if missing:
            raise NotImplementedError("the monoid pull needs "
                                      + " and ".join(missing))
    elif isinstance(pull_plan, ValuePlan):
        if not (or_pull or (not structure_only
                            and semiring.name == "PlusMultiplies")):
            raise NotImplementedError(
                f"the {semiring.name} pull over a value plan is not ported: "
                "the min/max semirings run over a MonoidPlan "
                "(plan_for_monoid, K4 of ROADMAP queue 2)")
        if or_pull and not pull_plan.unit_vals:
            # count>0 is the fused-or result only when every edge value is
            # 1: cancelling weights could sum to 0 for a reached vertex
            raise ValueError("the LogicalOrAnd pull needs a bitmap plan or a "
                             "unit-valued (ones=True) value plan")
    elif pull_plan is not None and not (or_pull and isinstance(pull_plan,
                                                               BitmapPlan)):
        raise NotImplementedError(
            f"the {semiring.name} pull over a {type(pull_plan).__name__} "
            "is not ported; pass no plan for spmv_pull")
    if pull_plan is not None and pull_plan.n_out != n_out:
        raise ValueError(f"plan has {pull_plan.n_out} output rows, the "
                         f"{'vxm' if transpose else 'mxv'} pull needs {n_out}")

    if pull_plan is None:   # the mask is applied below, for every route
        # only the min/max row fold reads a schedule
        sched = (schedule_for(A, transpose)
                 if minmax_supported(semiring, f.dense.dtype) else None)
        y = spmv_pull(pull_ptr, pull_ind, pull_val, f.dense, semiring, n_out,
                      structure_only=structure_only, sched=sched)
    elif isinstance(pull_plan, MonoidPlan):
        y = spmv_monoid(pull_plan, f.dense, semiring)
    else:
        if isinstance(pull_plan, BitmapPlan):
            # the bitmap plan ignores edge values
            cnt = spmv_bitmap_pull(pull_plan, pack_bitmap(f.dense))
        else:   # the kernel computes in float32, as the JAX kernel does
            cnt = spmv_value_pull(pull_plan, f.dense.to(torch.float32))
        # count>0 is the fused-or result
        y = (cnt > 0 if or_pull else cnt).to(f.dense.dtype)
    if mask_dense is not None:
        y = y.masked_fill(~mask_pass(mask_dense, mask_scmp),
                          semiring.identity(y.dtype).item())
    if postprocess is not None:
        y = postprocess(y)
    # pull-only loops skip re-sparsifying: only push reads sind/sval
    nv = (y != identity).sum().to(INDEX_DTYPE)
    use_sparse, ratio = update_direction(nv, n_out, f.ratio, f.use_sparse,
                                         switchpoint, mode)
    return (DualFrontier(n_out, y, f.sind, f.sval, nv, ratio, use_sparse),
            False)
