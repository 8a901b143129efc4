"""Direction-optimized mxv/vxm dispatch (counterpart of
graphblast_tpu/ops/dispatch.py; reference: backend/cuda/operations.hpp:82-327
and the direction heuristic, backend/cuda/vector.hpp:292-323).

`mxv_dual` runs one of three modes:
  - PULLONLY (dispatch.py:255-296 of the JAX package): over a plan, the
    structure-only LogicalOrAnd pull over a bitmap plan (K1, fused BFS) or
    a unit-valued value plan, the PlusMultiplies pull over a value plan
    (K2/K3), and the min/max semirings of the monoid pull over a monoid
    plan (K4, SSSP); with no plan, `spmv_pull` over the pull orientation
    (K5 and K6 for stepped BFS, the row fold S for a min/max semiring, with
    the orientation's cached row schedule); and the `postprocess` epilogue;
  - PUSHONLY (dispatch.py:432-436): over the push orientation, on one of
    three routes that `push_route` names: the bitmap push P
    (`ops/kernels/bitmap_push.py`) for a structure-only push under a
    duplicate-insensitive ⊕ (LogicalOr, Max) with no postprocess, as BFS's
    is; scatter pushes of one lane an edge over slices of the frontier for
    a valued Min or Max push, as SSSP's is; else the workspace push of
    `ops/spmspv.py`, with every gather on K6;
  - PUSHPULL (dispatch.py:437-450), the default: the density heuristic's
    preference, gated on edge_cap, picks one of the two each call.
A Matrix that lacks one orientation runs the direction it has, as the
reference's one-sided formats do.

Both images of the frontier stay valid every call, as in the JAX package's
default protocol; its opt-in one, which keeps only the image the last
direction made, is not ported. JAX sizes its push workspace from a few
fixed tiers and picks the direction and the tier on the device with conds;
here the frontier's degree total, its count and the direction preference
come to the host in one read a call, and the host picks the direction
and sizes the push from the exact degree total (`route_lanes`). Where
JAX's PUSHONLY truncates a frontier whose degree total exceeds edge_cap,
the port raises ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..matrix import Matrix
from ..semiring import Semiring
from ..types import INDEX_DTYPE, Direction, round_up
from ..utils.profiling import annotate
from ..vector import dense_from_sparse, sparse_from_dense
from .kernels.bitmap_pull import BitmapPlan, pack_bitmap, spmv_bitmap_pull
from .kernels.bitmap_push import push_lanes, spmspv_push_bitmap
from .kernels.minmax_pull import minmax_supported
from .kernels.monoid_pull import MonoidPlan, monoid_supported, spmv_monoid
from .kernels.row_schedule import schedule_for
from .kernels.value_pull import ValuePlan, spmv_value_pull
from .spmspv import (_ORDERED, DUP_INSENSITIVE, frontier_degrees,
                     spmspv_push, spmspv_push_exact, spmspv_push_sparse)
from .spmv import mask_pass, spmv_pull

# the push routes `push_route` names
BITMAP, SLICES, WORKSPACE = "bitmap", "slices", "workspace"


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
    dense→sparse when density ≤ switchpoint and falling. `prev_sparse` is
    whether the call pushed, a bool or a 0-d bool tensor. Returns
    (use_sparse, ratio)."""
    ratio = nv.float() / n
    # filled on the device: torch.tensor(..., device=) would copy from
    # the host and wait for the stream
    true = torch.ones((), dtype=torch.bool, device=nv.device)
    if mode == Direction.PUSHONLY:
        return true, ratio
    if mode == Direction.PULLONLY:
        return ~true, ratio
    if isinstance(prev_sparse, bool):
        prev_sparse = true if prev_sparse else ~true
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


def _host_state(push_ptr: torch.Tensor, f: DualFrontier, identity) -> tuple:
    """(deg_total, snvals, use_sparse) as Python values, in one host read:
    the direction, the push's gate and its lanes all follow from them."""
    vals = torch.stack([t.to(torch.int64) for t in (
        _frontier_degree_total(push_ptr, f, identity), f.snvals,
        f.use_sparse)])
    with annotate("gb.dispatch.read"):
        deg_total, snvals, use_sparse = vals.tolist()
    return deg_total, snvals, bool(use_sparse)


def frontier_state(A: Matrix, f: DualFrontier, identity,
                   transpose: bool = False) -> tuple:
    """What `mxv_dual(A, f, ..., transpose=transpose)` reads of f before it
    picks a direction (`_host_state`: the degree total, snvals and the
    direction preference), in one host read, for a loop that reads f's
    count anyway: it hands the tuple to mxv_dual as `state`, and the
    dispatch reads nothing more."""
    return _host_state(A.pull_csr(not transpose)[2], f, identity)


def push_route(semiring: Semiring, structure_only: bool, postprocess,
               postprocess_sparse) -> str:
    """The route a push takes. BITMAP, the bitmap push P: structure-only
    under a ⊕ that ignores duplicates (every edge carries a 1, which marks
    its destination once), with no postprocess to run on the result.
    SLICES, scatter pushes over slices of the frontier (`_push_sliced`): a
    valued push under Min or Max ⊕ (SSSP's MinimumPlus; `_ORDERED`, whose
    total ignores the order and grouping of its operands); one slice beats
    the workspace's sort push (SSSP on kron25w on an H100: 210 ms a call
    against 271), and the sort push's workspace at edge_cap would hold some
    50 B a lane, at a billion edges more than the card. WORKSPACE, every
    other push: `_push` in `route_lanes`' workspace."""
    if (structure_only and semiring.add.name in DUP_INSENSITIVE
            and postprocess is None and postprocess_sparse is None):
        return BITMAP
    if not structure_only and semiring.add.name in _ORDERED:
        return SLICES
    return WORKSPACE


def _capped_lanes(lanes: int, edge_cap: int) -> int:
    """`lanes` rounded up to 1,024 (at least 1,024), at most edge_cap."""
    return min(edge_cap, max(round_up(lanes, 1024), 1024))


def route_lanes(route: str, deg_total: int, snvals: int,
                edge_cap: int) -> int:
    """The lanes a push on `route` covers: P's whole blocks of
    EDGES_PER_BLOCK edges over the degree total; the slices' edges, one
    lane each; the workspace push's workspace, the degree total or the
    frontier's count, whichever is more, rounded up to 1,024 and capped at
    edge_cap (there it takes the whole frontier, whatever its count)."""
    if route == BITMAP:
        return push_lanes(deg_total)
    if route == SLICES:
        return deg_total
    return _capped_lanes(max(deg_total, snvals), edge_cap)


def slice_lanes(edge_cap: int) -> int:
    """The most edges a slice of `_push_sliced` holds (one vertex alone may
    hold more): edge_cap / 8, rounded as `_capped_lanes` rounds."""
    return _capped_lanes(edge_cap // 8, edge_cap)


def _push(push_csr, fin, cap: int, whole: bool, semiring: Semiring,
          identity, n_out: int, *, mask_dense, mask_scmp, structure_only,
          sort_push, postprocess, postprocess_sparse):
    """One push over push_csr, the (ptr, ind, val) of A's CSR for vxm and
    of its CSC for mxv, from the sparse image `fin` = (sind, sval, snvals),
    in a workspace of `cap` lanes (`route_lanes`'; `whole` where that is
    edge_cap). Returns (y, sind, sval, nv)."""
    push_ptr, push_ind, push_val = push_csr
    f_sind, f_sval, f_snvals = fin
    # below edge_cap the workspace holds the whole frontier (snvals <=
    # cap): every stage of the expansion then scales with it, not with n
    fs = f_sind if whole else f_sind[:cap]
    fv = f_sval[:fs.shape[0]] if f_sval is not None else None
    with_vals = not structure_only
    if sort_push and (postprocess is None or postprocess_sparse is not None):
        # the MERGE push compacts the new frontier inside the workspace
        return spmspv_push_sparse(
            push_ptr, push_ind, push_val, fs, fv, f_snvals, semiring, n_out,
            cap, mask_dense, mask_scmp, structure_only,
            with_values=with_vals, postprocess_sparse=postprocess_sparse)
    y = spmspv_push(push_ptr, push_ind, push_val, fs, fv, f_snvals,
                    semiring, n_out, cap, mask_dense, mask_scmp,
                    structure_only, sort_push)
    return _finish_dense(y, identity, postprocess, with_vals, True, fin)


def slice_bounds(push_ptr: torch.Tensor, f_sind: torch.Tensor, snvals: int,
                 lanes: int, deg_total: int) -> list:
    """[(start, end, edges)]: the frontier slots sind[:snvals], whose
    degree total is deg_total, cut in order into runs whose degree total is
    at most `lanes` (a run of one vertex holds that vertex's edges,
    whatever their number), each as long as that allows. Any two runs in a
    row hold more than `lanes` edges, so 2·⌈deg_total / lanes⌉ greedy steps
    on the device cut them all, and one host read brings them; a frontier
    within `lanes` is one slice, with no read."""
    if deg_total <= lanes:
        return [(0, snvals, deg_total)]
    deg = frontier_degrees(push_ptr, f_sind[:snvals], snvals)
    # incl[i]: the degree total of slots [0, i)
    incl = torch.cumsum(torch.cat([deg.new_zeros(1), deg]), 0,
                        dtype=torch.int64)
    at, ends = incl.new_zeros(1), []
    for _ in range(2 * -(-deg_total // lanes)):
        # the last slot boundary within `lanes` of the run's start
        reach = torch.searchsorted(incl, incl[at] + lanes, right=True)
        at = torch.maximum(reach - 1, at + 1).clamp(max=snvals)
        ends.append(at)
    ends = torch.cat(ends)
    out, start, done = [], 0, 0
    for end, total in zip(*torch.stack([ends, incl[ends]]).tolist()):
        if end > start:
            out.append((start, end, total - done))
            start, done = end, total
    if start != snvals:
        raise RuntimeError(f"the frontier's degree total is not {deg_total}")
    return out


def _push_sliced(push_csr, fin, lanes: int, snvals: int, deg_total: int,
                 semiring: Semiring, identity, n_out: int, *, mask_dense,
                 mask_scmp, postprocess) -> tuple:
    """A push in slices of the frontier (`slice_bounds`), each of at most
    `lanes` (`slice_lanes`') edges but where one vertex has more, each
    scattered with one lane an edge into one dense result
    (`spmspv_push_exact`; exact: Min and Max ignore the order), then
    `postprocess` and one re-sparsification. Returns (y, sind, sval,
    nv)."""
    push_ptr, push_ind, push_val = push_csr
    f_sind, f_sval, _ = fin
    y = None
    for start, end, edges in slice_bounds(push_ptr, f_sind, snvals, lanes,
                                          deg_total):
        fv = f_sval[start:end] if f_sval is not None else None
        y = spmspv_push_exact(push_ptr, push_ind, push_val,
                              f_sind[start:end], fv, edges, semiring, n_out,
                              mask_dense, mask_scmp, out=y)
    return _finish_dense(y, identity, postprocess, True, True, fin)


def _finish_dense(y: torch.Tensor, identity, postprocess, with_vals: bool,
                  resparsify: bool, carry) -> tuple:
    """The epilogue of a dense-only producer (a pull, the SIMPLE push):
    `postprocess`, then, with `resparsify`, the full-n re-sparsification
    (the reference's streamCompact, vector.hpp:367-425), so that the next
    push reads a valid sparse image. Without it (pull-only loops) the
    count is a reduction and the sparse image `carry` = (sind, sval,
    snvals) stays stale. Returns (y, sind, sval, nv)."""
    if postprocess is not None:
        y = postprocess(y)
    if not resparsify:
        nv = (y != identity).sum().to(INDEX_DTYPE)
        return y, carry[0], carry[1], nv
    sind, sval, nv = sparse_from_dense(y, identity, with_values=with_vals)
    return y, sind, sval, nv


def _plan_serves(pull_plan, semiring: Semiring, structure_only: bool,
                 dtype: torch.dtype, n_out: int, transpose: bool) -> bool:
    """Whether `pull_plan` runs this pull, as the JAX dispatch decides
    (graphblast_tpu/ops/dispatch.py:251-296): a BitmapPlan the
    structure-only LogicalOrAnd pull, a ValuePlan that pull (unit values
    only) or the PlusMultiplies pull, a MonoidPlan a min/max semiring of
    SEMIRING_MAP over a float32 frontier with values. Where it does not,
    the pull falls through to `spmv_pull`. Raises for the or-pull over a
    plan with stored values (JAX asserts) and for a plan of another size."""
    if pull_plan is None:
        return False
    or_pull = structure_only and semiring.name == "LogicalOrAnd"
    if isinstance(pull_plan, MonoidPlan):
        serves = (not structure_only and monoid_supported(semiring)
                  and dtype == torch.float32)
    elif or_pull:
        if isinstance(pull_plan, ValuePlan) and not pull_plan.unit_vals:
            # count>0 is the fused-or result only when every edge value is
            # 1: cancelling weights could sum to 0 for a reached vertex
            raise ValueError("the LogicalOrAnd pull needs a bitmap plan or a "
                             "unit-valued (ones=True) value plan")
        serves = True
    else:
        serves = (isinstance(pull_plan, ValuePlan) and not structure_only
                  and semiring.name == "PlusMultiplies")
    if serves and pull_plan.n_out != n_out:
        raise ValueError(f"plan has {pull_plan.n_out} output rows, the "
                         f"{'vxm' if transpose else 'mxv'} pull needs {n_out}")
    return serves


def _pull(A: Matrix, fd: torch.Tensor, semiring: Semiring, n_out: int,
          pull_csr, transpose: bool, *, mask_dense, mask_scmp,
          structure_only, pull_plan, bound) -> torch.Tensor:
    """y = the pull of the dense frontier `fd` over pull_csr, the (ptr, ind,
    val) of A's CSR for mxv and of its CSC for vxm, under the mask: through
    `pull_plan`'s kernel, or `spmv_pull` without a plan. A BitmapPlan
    under a float32 mask takes K1's masked entry, which applies the mask
    itself and stops each open row at its first frontier neighbour; a
    MonoidPlan under MinimumPlus with a `bound` takes K4's masked entry
    (`spmv_monoid`'s `bound`)."""
    pull_ptr, pull_ind, pull_val = pull_csr
    if pull_plan is None:   # the mask is applied below, for every route
        # only the min/max row fold reads a schedule
        sched = (schedule_for(A, transpose)
                 if minmax_supported(semiring, fd.dtype) else None)
        y = spmv_pull(pull_ptr, pull_ind, pull_val, fd, semiring, n_out,
                      structure_only=structure_only, sched=sched)
    elif isinstance(pull_plan, MonoidPlan):
        y = spmv_monoid(pull_plan, fd, semiring, bound=bound)
    else:
        if isinstance(pull_plan, BitmapPlan):
            # the bitmap plan ignores edge values
            if mask_dense is not None and mask_dense.dtype == torch.float32:
                pull_plan = dataclasses.replace(pull_plan, mask=mask_dense,
                                                mask_scmp=mask_scmp)
                mask_dense = None     # the kernel applied it
            cnt = spmv_bitmap_pull(pull_plan, pack_bitmap(fd))
        else:   # the kernel computes in float32, as the JAX kernel does
            cnt = spmv_value_pull(pull_plan, fd.to(torch.float32))
        # count>0 is the fused-or result
        or_pull = structure_only and semiring.name == "LogicalOrAnd"
        y = (cnt > 0 if or_pull else cnt).to(fd.dtype)
    if mask_dense is not None:
        y = y.masked_fill(~mask_pass(mask_dense, mask_scmp),
                          semiring.identity(y.dtype).item())
    return y


def mxv_dual(A: Matrix, f: DualFrontier, semiring: Semiring, identity, *,
             transpose: bool = False,
             mask_dense: Optional[torch.Tensor] = None,
             mask_scmp: bool = False, structure_only: bool = False,
             edge_cap: Optional[int] = None, sort_push: bool = True,
             switchpoint: float = 0.01, mode=None,
             postprocess: Optional[Callable] = None,
             postprocess_sparse: Optional[Callable] = None,
             pull_plan=None, bound: Optional[torch.Tensor] = None,
             state: Optional[tuple] = None):
    """One y = A ⊗ f (or fᵀ ⊗ A when transpose), returning a new
    DualFrontier and whether push ran, a Python bool (reference:
    operations.hpp:108-199 vxm + convert()).

    `mode` PULLONLY pulls; PUSHONLY pushes; PUSHPULL (the default) pushes
    when the frontier prefers it (`use_sparse`, the heuristic's last
    verdict) and its degree total fits edge_cap (A's nnz_pad by default),
    else pulls. A Matrix without the push orientation pulls and one
    without the pull orientation pushes, whatever `mode` says.

    Pull: `pull_plan` is None, for `spmv_pull` over the pull orientation's
    arrays (CSC for vxm, CSR for mxv) with any semiring, or a plan of that
    orientation: a BitmapPlan for the structure-only LogicalOrAnd pull, a
    ValuePlan for that pull (unit values only) or the PlusMultiplies pull,
    or a MonoidPlan for a min/max semiring of SEMIRING_MAP over a float32
    frontier; a plan that does not serve the pull is passed over for
    `spmv_pull`, as in the JAX package. `postprocess(y)` runs after the
    mask and before the count of non-identity entries. `bound`, a
    float32 (n_out,) tensor, is such a postprocess, given as data: every
    route writes the identity at each y[i] >= bound[i] (SSSP's filter
    against its distances), and the call takes no other postprocess. A
    MinimumPlus pull over a MonoidPlan then takes K4's masked entry, which
    skips the rows and the columns off the frontier that the filter
    would empty (`spmv_monoid`'s `bound`).
    PULLONLY keeps the sparse image stale (only push reads it); a PUSHPULL
    pull rebuilds it, since the next call may push.

    Push reads the frontier's sparse image (which must hold no
    identity-valued entry, see DualFrontier.from_sparse), ignores
    `pull_plan`, and takes the route `push_route` names. BITMAP and SLICES
    ignore `sort_push`: the bitmap push gives the images every lowering
    gives, and the slices are scatter pushes of one lane an edge, each of
    at most `slice_lanes(edge_cap)` edges in degree total (one slice where
    the frontier fits), into one dense result, then `postprocess` and one
    re-sparsification. WORKSPACE expands the frontier into
    `route_lanes(WORKSPACE, ...)` lanes; there `sort_push` picks the MERGE
    sort push, which builds the sparse image from its own sort, over the
    SIMPLE scatter push, and a `postprocess` without its sparse twin
    `postprocess_sparse(keys, vals)` sends it to the dense route and the
    full-n re-sparsification. A degree total past edge_cap pulls under
    PUSHPULL and raises ValueError under PUSHONLY.

    PUSHPULL and PUSHONLY read the frontier's state on the host once a
    call (`_host_state`), or take it as `state` from a caller that read it
    with `frontier_state`; PULLONLY reads nothing. Under a profiler the
    call records the spans "gb.dispatch.read" (that read), "gb.push" and
    "gb.pull" (each direction's enqueue, the pull's re-sparsification
    included); each push adds to the counters `mxv_dual.push_edges`,
    `.push_lanes`, `.top_tier_pushes`, `.bitmap_pushes` and
    `.sliced_pushes`."""
    mode = mode if mode is not None else Direction.PUSHPULL
    if bound is not None:
        if postprocess is not None or postprocess_sparse is not None:
            raise ValueError("a bound is the call's postprocess; give no "
                             "other")

        def postprocess(y):
            return torch.where(y < bound, y, identity)
    n_out, _, pull_ptr, pull_ind, pull_val = A.pull_csr(transpose)
    # push expands the input's adjacency: the other orientation
    push_csr = A.pull_csr(not transpose)[2:]
    if push_csr[0] is None:   # one-sided storage forces one direction
        mode = Direction.PULLONLY
    if pull_ptr is None:
        mode = Direction.PUSHONLY
    with_vals = not structure_only

    def pull(fd):
        return _pull(A, fd, semiring, n_out, (pull_ptr, pull_ind, pull_val),
                     transpose, mask_dense=mask_dense, mask_scmp=mask_scmp,
                     structure_only=structure_only, pull_plan=pull_plan,
                     bound=bound)

    if mode != Direction.PUSHONLY and not _plan_serves(
            pull_plan, semiring, structure_only, f.dense.dtype, n_out,
            transpose):
        pull_plan = None
    carry = (f.sind, f.sval, f.snvals)
    if mode == Direction.PULLONLY:
        # pull-only loops skip re-sparsifying: only push reads sind/sval
        with annotate("gb.pull"):
            y, sind, sval, nv = _finish_dense(pull(f.dense), identity,
                                              postprocess, with_vals, False,
                                              carry)
        use_sparse, ratio = update_direction(nv, n_out, f.ratio, False,
                                             switchpoint, mode)
        return DualFrontier(n_out, y, sind, sval, nv, ratio, use_sparse), False

    deg_total, snvals, use_sparse = (
        _host_state(push_csr[0], f, identity) if state is None else state)
    edge_cap = A.nnz_pad if edge_cap is None else edge_cap
    if mode == Direction.PUSHONLY:
        if deg_total > edge_cap:
            raise ValueError(
                f"the frontier's degree total {deg_total} exceeds the push "
                f"workspace edge_cap={edge_cap}; raise the descriptor's "
                "memusage or pull")
        use_push = True
    else:
        # JAX's semantics (dispatch.py:440), not a fallback: a frontier
        # whose expansion would not fit the workspace pulls
        use_push = use_sparse and deg_total <= edge_cap
    if use_push:
        route = push_route(semiring, structure_only, postprocess,
                           postprocess_sparse)
        lanes = route_lanes(route, deg_total, snvals, edge_cap)
        most = slice_lanes(edge_cap)
        # host ints the read above brought: counting adds no sync
        mxv_dual.push_edges += deg_total
        mxv_dual.push_lanes += lanes
        mxv_dual.top_tier_pushes += lanes >= edge_cap
        mxv_dual.bitmap_pushes += route == BITMAP
        mxv_dual.sliced_pushes += route == SLICES and deg_total > most
        with annotate("gb.push"):
            if route == BITMAP:
                y, sind, sval, nv = spmspv_push_bitmap(
                    push_csr[0], push_csr[1], f.sind, snvals, deg_total,
                    mask_dense, mask_scmp, n_out,
                    torch.float32 if f.sval is None else f.sval.dtype)
            elif route == SLICES:
                y, sind, sval, nv = _push_sliced(
                    push_csr, carry, most, snvals, deg_total, semiring,
                    identity, n_out, mask_dense=mask_dense,
                    mask_scmp=mask_scmp, postprocess=postprocess)
            else:
                y, sind, sval, nv = _push(
                    push_csr, carry, lanes, lanes == edge_cap, semiring,
                    identity, n_out, mask_dense=mask_dense,
                    mask_scmp=mask_scmp, structure_only=structure_only,
                    sort_push=sort_push, postprocess=postprocess,
                    postprocess_sparse=postprocess_sparse)
    else:
        with annotate("gb.pull"):
            y, sind, sval, nv = _finish_dense(pull(f.dense), identity,
                                              postprocess, with_vals, True,
                                              carry)
    # hysteresis compares with the direction this call ran
    # (dispatch.py:448), not with the preference it was given
    use_sparse, ratio = update_direction(nv, n_out, f.ratio, use_push,
                                         switchpoint, mode)
    return DualFrontier(n_out, y, sind, sval, nv, ratio, use_sparse), use_push


# the push's counters, read as the kernels' .launches are: the frontier's
# degree total summed over the pushes, the lanes each covered
# (`route_lanes`), the pushes whose lanes reached edge_cap, the pushes that
# took the bitmap push, and the pushes in slices whose degree total passed
# `slice_lanes` (cut into more than one slice, but for a lone hub)
mxv_dual.push_edges = 0
mxv_dual.push_lanes = 0
mxv_dual.top_tier_pushes = 0
mxv_dual.bitmap_pushes = 0
mxv_dual.sliced_pushes = 0
