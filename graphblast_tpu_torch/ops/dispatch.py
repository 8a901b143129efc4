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
  - PUSHONLY (dispatch.py:432-436): over the push orientation, the
    bitmap push P (`ops/kernels/bitmap_push.py`) where the push is
    structure-only under a duplicate-insensitive ⊕ (LogicalOr, Max) in the
    eager protocol with no postprocess, as BFS's is; else the push of
    `ops/spmspv.py`, with every gather on K6;
  - PUSHPULL (dispatch.py:437-450), the default: the density heuristic's
    preference, gated on the push workspace, picks one of the two each
    call.
A Matrix that lacks one orientation runs the direction it has, as the
reference's one-sided formats do.

Both images of the frontier stay valid every call (the eager protocol)
unless the caller passes `lazy=True`, the JAX package's opt-in lazy
dual-frontier protocol: each direction keeps only its own image, the
sparse one bounded by LAZY_SPARSE_CAP, and the other is rebuilt at a
switch.

The push of `ops/spmspv.py` takes a workspace of one of a few fixed sizes
(tiers: edge_cap/64, edge_cap/8, edge_cap, each rounded up to 1,024), as in
the JAX package; the bitmap push needs none, and an eager valued Min or Max
push runs as scatter pushes of one lane an edge over slices of the
frontier, none past the second tier, into one dense result. JAX
picks the direction and the tier on the device with conds; here the
frontier's degree total, its count, the direction preference and the lazy
flags come to the host in one read a call, and the host picks. Where JAX's
PUSHONLY truncates a frontier whose degree total exceeds edge_cap, the port
raises ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

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

# the bound on the sparse image a lazy push leaves behind: lazy consumers
# (the BFS label assign, the SSSP relax, the degree total) touch only
# sind[:LAZY_SPARSE_CAP]; a larger push output keeps its dense image
LAZY_SPARSE_CAP = 8192

Flag = Union[bool, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DualFrontier:
    """Frontier with both storage images and the direction preference.

    dense (n,), sind (cap,), sval (cap,) or None, snvals, ratio and
    use_sparse as tensors on the frontier's device. A pull-only loop keeps
    the sparse image stale: only push reads it.

    dense_ok / sparse_ok say which image is valid under the lazy protocol
    (always True in the eager one): Python bools where the host knows them,
    0-d bool tensors after a lazy push whose output may pass
    LAZY_SPARSE_CAP. At least one is True; sparse_ok implies snvals <=
    LAZY_SPARSE_CAP.
    """

    n: int
    dense: torch.Tensor
    sind: torch.Tensor
    sval: Optional[torch.Tensor]
    snvals: torch.Tensor
    ratio: torch.Tensor       # previous nnz/n (hysteresis state)
    use_sparse: torch.Tensor  # bool: push preferred
    dense_ok: Flag = True
    sparse_ok: Flag = True

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


def _host_state(push_ptr: torch.Tensor, f: DualFrontier, identity,
                sp: int) -> tuple:
    """(deg_total, snvals, use_sparse, dense_ok, sparse_ok) as Python
    values, in one host read: the direction, the push's gate and its tier
    all follow from them.

    The degree total comes from the dense image where the host knows it is
    valid, else from sind[:sp] (`frontier_degrees`, two gathers), as JAX's
    lazy `_deg_total` takes it. With tensor flags (a lazy push's output)
    that is exact where sparse_ok holds; where it does not, snvals > sp and
    the lazy gate pulls, so the total is not used."""
    if f.dense_ok is True:
        deg_total = _frontier_degree_total(push_ptr, f, identity)
    else:
        deg_total = frontier_degrees(push_ptr, f.sind[:sp], f.snvals).sum()
    parts = [deg_total, f.snvals, f.use_sparse]
    flags = [flag for flag in (f.dense_ok, f.sparse_ok)
             if isinstance(flag, torch.Tensor)]
    vals = torch.stack([t.to(torch.int64) for t in parts + flags])
    with annotate("gb.dispatch.read"):
        vals = vals.tolist()
    deg_total, snvals, use_sparse = vals[0], vals[1], bool(vals[2])
    read = iter(bool(x) for x in vals[3:])
    dense_ok, sparse_ok = (flag if isinstance(flag, bool) else next(read)
                           for flag in (f.dense_ok, f.sparse_ok))
    return deg_total, snvals, use_sparse, dense_ok, sparse_ok


def frontier_state(A: Matrix, f: DualFrontier, identity,
                   transpose: bool = False) -> tuple:
    """What `mxv_dual(A, f, ..., transpose=transpose)` reads of f before it
    picks a direction (`_host_state`: the degree total, snvals, the
    direction preference and the images' flags), in one host read, for a
    loop that reads f's count anyway: it hands the tuple to mxv_dual as
    `state`, and the dispatch reads nothing more."""
    return _host_state(A.pull_csr(not transpose)[2], f, identity,
                       min(LAZY_SPARSE_CAP, f.sind.shape[0]))


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


def _materialize_dense(f: DualFrontier, identity, sp: int) -> torch.Tensor:
    """The dense image rebuilt from sind[:sp] at a push→pull switch: an
    identity-filled (n,) with the stored entries scattered in (ones where
    there are no values), pad slots into a spare slot past the end."""
    n = f.dense.shape[0]
    dev = f.dense.device
    tgt = torch.where(torch.arange(sp, dtype=INDEX_DTYPE, device=dev)
                      < f.snvals, f.sind[:sp], n).long()
    vals = (f.sval[:sp].to(f.dense.dtype) if f.sval is not None
            else torch.ones(sp, dtype=f.dense.dtype, device=dev))
    out = torch.full((n + 1,), identity, dtype=f.dense.dtype, device=dev)
    out[tgt] = vals
    return out[:n]


def _dense_image(f: DualFrontier, identity, sp: int,
                 dense_ok: Flag) -> torch.Tensor:
    """f's dense image, rebuilt from the sparse one where `dense_ok` says it
    is stale (selected on the device for a tensor flag)."""
    if dense_ok is True:
        return f.dense
    built = _materialize_dense(f, identity, sp)
    return built if dense_ok is False else torch.where(dense_ok, f.dense,
                                                       built)


def _sparsify(f: DualFrontier, identity) -> tuple:
    """The sparse image rebuilt from the dense one at a pull→push switch:
    the full-n `sparse_from_dense`, cut to the carry's capacity (the lazy
    gate pushes only a frontier that fits it)."""
    sind, sval, nv = sparse_from_dense(f.dense, identity,
                                       with_values=f.sval is not None)
    k = f.sind.shape[0]
    return sind[:k], (sval[:k] if sval is not None else None), nv


def _takes_bitmap_push(semiring: Semiring, structure_only: bool, lazy: bool,
                       postprocess, postprocess_sparse) -> bool:
    """Whether a push is the bitmap push: structure-only under a ⊕ that
    ignores duplicates (every edge carries a 1, which marks its destination
    once), in the eager protocol, with no postprocess to run on the
    result."""
    return (structure_only and semiring.add.name in DUP_INSENSITIVE
            and not lazy and postprocess is None
            and postprocess_sparse is None)


def _push(push_csr, fin, deg_total: int, cap: int, whole: bool,
          semiring: Semiring, identity, n_out: int, *, mask_dense, mask_scmp,
          structure_only, sort_push, postprocess, postprocess_sparse, lazy,
          sp, stale_dense):
    """One push over push_csr, the (ptr, ind, val) of A's CSR for vxm and
    of its CSC for mxv, from the sparse image `fin` = (sind, sval, snvals),
    in a workspace of `cap` lanes (`pick_tier`'s; `whole` where that is the
    last tier). Returns (y, sind, sval, nv, dense_ok, sparse_ok).

    Lazy: the sparse image compacts into sp slots and the dense image is
    the stale one carried in. A push whose degree total is at most sp
    cannot find more than sp entries, so its flags are known here:
    (False, True). A larger one may overflow: `spmspv_push_sparse` then
    builds the dense image from the workspace where nv > sp, chosen on the
    device, and the flags are the tensors (nv > sp, nv <= sp)."""
    push_ptr, push_ind, push_val = push_csr
    f_sind, f_sval, f_snvals = fin
    # a lower tier holds the whole frontier (snvals <= cap): every stage of
    # the expansion then scales with the tier, not with n
    fs = f_sind if whole else f_sind[:cap]
    fv = f_sval[:fs.shape[0]] if f_sval is not None else None
    with_vals = not structure_only
    if sort_push and (postprocess is None or postprocess_sparse is not None):
        # the MERGE push compacts the new frontier inside the workspace
        small = deg_total <= sp
        y, sind, sval, nv = spmspv_push_sparse(
            push_ptr, push_ind, push_val, fs, fv, f_snvals, semiring, n_out,
            cap, mask_dense, mask_scmp, structure_only,
            with_values=with_vals, postprocess_sparse=postprocess_sparse,
            build_dense=not lazy, out_cap=sp if lazy else None,
            stale_dense=None if small else stale_dense)
        if not lazy:
            return y, sind, sval, nv, True, True
        if small:
            return stale_dense, sind, sval, nv, False, True
        fits = nv <= sp
        return y, sind, sval, nv, ~fits, fits
    y = spmspv_push(push_ptr, push_ind, push_val, fs, fv, f_snvals,
                    semiring, n_out, cap, mask_dense, mask_scmp,
                    structure_only, sort_push)
    return _finish_dense(y, identity, postprocess, with_vals, not lazy, fin)


def _takes_slices(semiring: Semiring, structure_only: bool,
                  lazy: bool) -> bool:
    """Whether a push runs as scatter pushes over slices of the frontier
    (`_push_sliced`): an eager valued push under Min or Max ⊕ (SSSP's
    MinimumPlus; `_ORDERED`, whose total ignores the order and grouping of
    its operands). Its lanes then stay within the second tier, where
    the sort push's last tier would hold some 50 B a lane, at a billion
    edges more than the card; below the second tier one scatter slice
    also beats the sort push (SSSP on kron25w on an H100: 210 ms a call
    against 271), and one lane an edge (`spmspv_push_exact`) enqueues a
    third of the workspace push's ops."""
    return not structure_only and not lazy and semiring.add.name in _ORDERED


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
    `lanes` (the second tier's) edges but where one vertex has more, each
    scattered with one lane an edge into one dense result
    (`spmspv_push_exact`; exact: Min and Max ignore the order), then
    `postprocess` and one re-sparsification. Returns (y, sind, sval, nv,
    the lanes the slices took: the frontier's edges)."""
    push_ptr, push_ind, push_val = push_csr
    f_sind, f_sval, _ = fin
    y, taken = None, 0
    for start, end, edges in slice_bounds(push_ptr, f_sind, snvals, lanes,
                                          deg_total):
        fv = f_sval[start:end] if f_sval is not None else None
        y = spmspv_push_exact(push_ptr, push_ind, push_val,
                              f_sind[start:end], fv, edges, semiring, n_out,
                              mask_dense, mask_scmp, out=y)
        taken += edges
    y, sind, sval, nv, _, _ = _finish_dense(y, identity, postprocess, True,
                                            True, fin)
    return y, sind, sval, nv, taken


def _finish_dense(y: torch.Tensor, identity, postprocess, with_vals: bool,
                  resparsify: bool, carry) -> tuple:
    """The epilogue of a dense-only producer (a pull, the SIMPLE push):
    `postprocess`, then, with `resparsify`, the full-n re-sparsification
    (the reference's streamCompact, vector.hpp:367-425), so that the next
    push reads a valid sparse image. Without it (lazy callers, pull-only
    loops) the count is a reduction, the sparse image `carry` = (sind,
    sval, snvals) stays stale and the flags say so."""
    if postprocess is not None:
        y = postprocess(y)
    if not resparsify:
        nv = (y != identity).sum().to(INDEX_DTYPE)
        return y, carry[0], carry[1], nv, True, False
    sind, sval, nv = sparse_from_dense(y, identity, with_values=with_vals)
    return y, sind, sval, nv, True, True


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
          structure_only, pull_plan) -> torch.Tensor:
    """y = the pull of the dense frontier `fd` over pull_csr, the (ptr, ind,
    val) of A's CSR for mxv and of its CSC for vxm, under the mask: through
    `pull_plan`'s kernel, or `spmv_pull` without a plan. A BitmapPlan
    under a float32 mask takes K1's masked entry, which applies the mask
    itself and stops each open row at its first frontier neighbour."""
    pull_ptr, pull_ind, pull_val = pull_csr
    if pull_plan is None:   # the mask is applied below, for every route
        # only the min/max row fold reads a schedule
        sched = (schedule_for(A, transpose)
                 if minmax_supported(semiring, fd.dtype) else None)
        y = spmv_pull(pull_ptr, pull_ind, pull_val, fd, semiring, n_out,
                      structure_only=structure_only, sched=sched)
    elif isinstance(pull_plan, MonoidPlan):
        y = spmv_monoid(pull_plan, fd, semiring)
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
             tier_divisors: tuple = (64, 8), pull_plan=None,
             lazy: bool = False, state: Optional[tuple] = None):
    """One y = A ⊗ f (or fᵀ ⊗ A when transpose), returning a new
    DualFrontier and whether push ran, a Python bool (reference:
    operations.hpp:108-199 vxm + convert()).

    `mode` PULLONLY pulls; PUSHONLY pushes; PUSHPULL (the default) pushes
    when the frontier prefers it (`use_sparse`, the heuristic's last
    verdict) and its degree total fits edge_cap, else pulls. A Matrix
    without the push orientation pulls and one without the pull
    orientation pushes, whatever `mode` says.

    Pull: `pull_plan` is None, for `spmv_pull` over the pull orientation's
    arrays (CSC for vxm, CSR for mxv) with any semiring, or a plan of that
    orientation: a BitmapPlan for the structure-only LogicalOrAnd pull, a
    ValuePlan for that pull (unit values only) or the PlusMultiplies pull,
    or a MonoidPlan for a min/max semiring of SEMIRING_MAP over a float32
    frontier; a plan that does not serve the pull is passed over for
    `spmv_pull`, as in the JAX package. `postprocess(y)` runs after the
    mask and before the count of non-identity entries. PULLONLY keeps the
    sparse image stale (only push reads it); a PUSHPULL pull rebuilds it,
    since the next call may push.

    Push reads the frontier's sparse image (which must hold no
    identity-valued entry, see DualFrontier.from_sparse) and ignores
    `pull_plan`. A structure-only push under LogicalOr or Max ⊕, eager and
    with neither postprocess, is the bitmap push (`_takes_bitmap_push`),
    whatever `sort_push` says: both lowerings give it the same images.
    Every other push but the one below takes a workspace, the smallest of
    `push_tiers(edge_cap, tier_divisors)` that holds the frontier (edge_cap
    defaults to A's nnz_pad). `sort_push` picks the MERGE sort push, which
    builds the sparse image from its own sort, over the SIMPLE scatter
    push; a `postprocess` without its sparse twin `postprocess_sparse(keys,
    vals)` sends the push to the dense route and the full-n
    re-sparsification. An eager valued push under Min or Max ⊕ takes
    neither, whatever `sort_push` says (`_takes_slices`, `_push_sliced`):
    the frontier cut into slices of at most the second tier's lanes in
    degree total (one slice where it fits), each scattered with one lane an
    edge into one dense result (exact, as the order does not count), then
    `postprocess` and one re-sparsification.
    A degree total past edge_cap pulls under PUSHPULL and raises under
    PUSHONLY, on either push.

    `lazy=True` is the lazy dual-frontier protocol (see DualFrontier): a
    push keeps the sparse image only (LAZY_SPARSE_CAP slots) and a pull
    the dense one only; the missing image is rebuilt at a switch, and a
    pull-produced frontier switches to push only when it fits the sparse
    carry. It needs a square operand. A push-only run keeps the eager
    protocol, as the JAX loops ask for it.

    PUSHPULL and PUSHONLY read the frontier's state on the host once a
    call (`_host_state`), or take it as `state` from a caller that read it
    with `frontier_state`; PULLONLY reads nothing. Under a profiler the
    call records the spans "gb.dispatch.read" (that read), "gb.push" and
    "gb.pull" (each direction's enqueue, the pull's re-sparsification
    included); each push adds to the counters `mxv_dual.push_edges`,
    `.push_lanes`, `.top_tier_pushes`, `.bitmap_pushes` and
    `.sliced_pushes`."""
    mode = mode if mode is not None else Direction.PUSHPULL
    n_out, _, pull_ptr, pull_ind, pull_val = A.pull_csr(transpose)
    # push expands the input's adjacency: the other orientation
    push_csr = A.pull_csr(not transpose)[2:]
    if push_csr[0] is None:   # one-sided storage forces one direction
        mode = Direction.PULLONLY
    if pull_ptr is None:
        mode = Direction.PUSHONLY
    if lazy and f.dense.shape[0] != n_out:
        raise ValueError("lazy mxv_dual requires a square operand (the "
                         "stale-image carry shares one vertex space)")
    # a frontier past the lazy carry can only be pulled: a push-only run
    # would truncate it, so it keeps both images valid
    lazy = lazy and mode != Direction.PUSHONLY
    sp = min(LAZY_SPARSE_CAP, f.sind.shape[0])
    with_vals = not structure_only

    def pull(fd):
        return _pull(A, fd, semiring, n_out, (pull_ptr, pull_ind, pull_val),
                     transpose, mask_dense=mask_dense, mask_scmp=mask_scmp,
                     structure_only=structure_only, pull_plan=pull_plan)

    if mode != Direction.PUSHONLY and not _plan_serves(
            pull_plan, semiring, structure_only, f.dense.dtype, n_out,
            transpose):
        pull_plan = None
    carry = (f.sind, f.sval, f.snvals)
    if mode == Direction.PULLONLY:
        # pull-only loops skip re-sparsifying: only push reads sind/sval
        with annotate("gb.pull"):
            y, sind, sval, nv, _, _ = _finish_dense(
                pull(_dense_image(f, identity, sp, f.dense_ok)), identity,
                postprocess, with_vals, False, carry)
        use_sparse, ratio = update_direction(nv, n_out, f.ratio, False,
                                             switchpoint, mode)
        return (DualFrontier(n_out, y, sind, sval, nv, ratio, use_sparse,
                             True, not lazy), False)

    deg_total, snvals, use_sparse, dense_ok, sparse_ok = (
        _host_state(push_csr[0], f, identity, sp) if state is None
        else state)
    tiers = push_tiers(A.nnz_pad if edge_cap is None else edge_cap,
                       tier_divisors)
    if mode == Direction.PUSHONLY:
        use_push = True
    else:
        # JAX's semantics (dispatch.py:440), not a fallback: a frontier
        # whose expansion would not fit the workspace pulls
        use_push = use_sparse and deg_total <= tiers[-1]
        if lazy:
            # a pull-produced frontier switches to push only if it fits
            # the lazy carry (bigger frontiers are pull's regime)
            use_push = use_push and (sparse_ok or snvals <= sp)
    if use_push:
        cap = pick_tier(tiers, deg_total, snvals)
        bitmap = _takes_bitmap_push(semiring, structure_only, lazy,
                                    postprocess, postprocess_sparse)
        sliced = not bitmap and _takes_slices(semiring, structure_only, lazy)
        # host ints the read above brought: counting adds no sync
        mxv_dual.push_edges += deg_total
        mxv_dual.bitmap_pushes += bitmap
        if not sliced:      # the slices count their own lanes below
            lanes = push_lanes(deg_total) if bitmap else cap
            mxv_dual.push_lanes += lanes
            mxv_dual.top_tier_pushes += lanes >= tiers[-1]
        with annotate("gb.push"):
            fin = carry if sparse_ok else _sparsify(f, identity)
            if bitmap:
                y, sind, sval, nv = spmspv_push_bitmap(
                    push_csr[0], push_csr[1], fin[0], snvals, deg_total,
                    mask_dense, mask_scmp, n_out,
                    torch.float32 if fin[1] is None else fin[1].dtype)
                dense_ok = sparse_ok = True
            elif sliced:
                most = tiers[-2] if len(tiers) > 1 else cap
                y, sind, sval, nv, taken = _push_sliced(
                    push_csr, fin, most, snvals, deg_total, semiring,
                    identity, n_out, mask_dense=mask_dense,
                    mask_scmp=mask_scmp, postprocess=postprocess)
                mxv_dual.push_lanes += taken
                mxv_dual.sliced_pushes += deg_total > most
                dense_ok = sparse_ok = True
            else:
                y, sind, sval, nv, dense_ok, sparse_ok = _push(
                    push_csr, fin, deg_total, cap, cap == tiers[-1],
                    semiring, identity, n_out, mask_dense=mask_dense,
                    mask_scmp=mask_scmp, structure_only=structure_only,
                    sort_push=sort_push, postprocess=postprocess,
                    postprocess_sparse=postprocess_sparse, lazy=lazy, sp=sp,
                    stale_dense=f.dense)
    else:
        with annotate("gb.pull"):
            y, sind, sval, nv, dense_ok, sparse_ok = _finish_dense(
                pull(_dense_image(f, identity, sp, dense_ok)), identity,
                postprocess, with_vals, not lazy, carry)
    # hysteresis compares with the direction this call ran
    # (dispatch.py:448), not with the preference it was given
    use_sparse, ratio = update_direction(nv, n_out, f.ratio, use_push,
                                         switchpoint, mode)
    return (DualFrontier(n_out, y, sind, sval, nv, ratio, use_sparse,
                         dense_ok, sparse_ok), use_push)


# the push's counters, read as the kernels' .launches are: the frontier's
# degree total summed over the pushes, the lanes each covered (its tier's
# workspace, the bitmap push's blocks, or a push in slices' edges, one
# lane each), the pushes whose one workspace reached edge_cap, the pushes
# that took the bitmap push, and the pushes in slices whose degree total
# passed the second tier (cut into more than one slice, but for a lone hub)
mxv_dual.push_edges = 0
mxv_dual.push_lanes = 0
mxv_dual.top_tier_pushes = 0
mxv_dual.bitmap_pushes = 0
mxv_dual.sliced_pushes = 0
