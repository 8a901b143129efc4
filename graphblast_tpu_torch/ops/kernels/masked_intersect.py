"""T1 and T2, the masked intersection of sorted rows: for each mask edge
e = (mi[e], mj[e]), la is A's row mi[e] (a_ptr, a_ind) and lb is B's list
mj[e] (b_ptr, b_ind: B's rows when B is taken transposed, else its CSC).

  T1 `masked_intersect_count`: Σ_e |la ∩ lb|, an exact Python int
     (triangle counting);
  T2 `masked_intersect_fold`: c[e] = ⊕_{k ∈ la ∩ lb} a_val[i,k] ⊗
     b_val[k,j], in a_val's dtype, with ⊕'s identity joined as below (the
     masked mxm, the trace). Where ⊕ is multiplies, greater, less or
     not-equal-to (`ORDERED_ADDS`: not associative, or rounding), the
     masked mxm's fold repeats the JAX join's order exactly (below).

Replaces no Pallas kernel: the JAX package computes both as plain jnp
(graphblast_tpu/ops/spgemm.py:159 _masked_count_chunk, :70
_masked_join_chunk), chunked sort joins shaped by the TPU's memory and its
lack of a fast binary search. On Hopper one kernel file
(csrc/masked_intersect.cu) walks the mask over an intersection schedule
(intersect_schedule.py, built once from the lengths and cached by
ops/spgemm.py): each edge takes the bitmap route (the block writes A's row
into a bitmap in shared memory once for the mask row, a warp streams B's
list against it) or the search route (a warp strides the shorter list, B's
only when strictly shorter as the JAX plan chooses, and finds each id with
a lower_bound in the longer one), whichever the schedule's cost formula
calls cheaper, and the search route where the bitmap would not fit the
shared-memory budget. Nothing is expanded, so no workspace, no chunk plan
and no lane cap is needed. T1 adds each block's count to one 64-bit total
with one atomicAdd (exact, and the same on every run); T2 folds each lane's
matches in its walk order from ⊕'s neutral, then the lanes through a fixed
butterfly of shuffles, so a launch is bitwise equal to any other on the
same schedule. ⊗ takes A's value first on either route. Both lists must be
sorted with no duplicate ids; ops/spgemm.py checks that once per Matrix.
Bound: the L1's rate of probes, which the bitmap route removes; the inputs
read once are the bytes bound chip_smoke.py reports.

Each fold starts at ⊕'s neutral element (±inf or the int32 limits for
min and max, 0 for plus and or). The semiring's identity joins it where
the JAX join brings it in, one identity for each walked id with no partner
(graphblast_tpu/ops/spgemm.py:145-154): for the masked mxm, whose plan
walks the shorter list, where the lists share fewer ids than the shorter
holds, or none (so an empty intersection gives the identity); for the
trace (`trace=True`), which tests every id of A's row (:705-723), where
A's row holds an id B's lacks. Only min and max see it, since there the
identity is not neutral: MaximumMonoid's is 0 (the reference's quirk), so
a max of negative products is 0 exactly where a walked id missed.

The ordered folds. The JAX join gives each mask edge one lane for each
id of the list it expands (the shorter; B's only when strictly shorter,
graphblast_tpu/ops/spgemm.py:247-330), in ascending order, holding the
product where the other list holds the id and ⊕'s identity where it does
not, and folds the lanes by a segmented Hillis–Steele scan
(graphblast_tpu/ops/segops.py:35-62); an edge with no lane gets the
identity, and where no edge of the mask has a lane the JAX plan is None
and the result zeros (ops/spgemm.py keeps that rule). The kernel
(`gb_masked_intersect_fold_ordered`, one warp an edge, no schedule)
reproduces the scan's bracketing from the lane offsets alone (its source
says how); the plain version builds the same lanes and runs
`segops.segmented_scan` over them. Both flush a subnormal float32 value
(each value read and each result of ⊗ and ⊕) to a zero of its sign, as
the JAX package's XLA does on the CPU and the TPU: a long product of
small values would otherwise end subnormal where JAX's ends at zero.

The plain versions are independent of the kernel's walk: they always
expand A's side and look each (j, k) up with `torch.searchsorted` on int64
keys over B's lists, chunked so the expansion fits (`_chunk_lanes`); on
CPU tensors the wrappers run them, on CUDA tensors they launch the kernel
or raise. Each launch is counted in the wrapper's `.launches`, and the edges
it sent down each route in its `.routes`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...types import INDEX_DTYPE
from ..segops import segmented_scan
from . import _build
from .intersect_schedule import IntersectSchedule, build_intersect_schedule

_LIBRARY = "masked_intersect"
_ERROR = "gb_masked_intersect_error_string"
_ERROR_SIG = ([ctypes.c_int], ctypes.c_char_p)
_COUNT_SIG = ([ctypes.c_void_p] * 9, ctypes.c_int)
_FOLD_SIG = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
             + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_ORDERED_SIG = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p],
                ctypes.c_int)
_SIGNATURES = {"gb_masked_intersect_count": _COUNT_SIG,
               "gb_masked_intersect_fold": _FOLD_SIG,
               "gb_masked_intersect_fold_ordered": _ORDERED_SIG,
               _ERROR: _ERROR_SIG}
_LAUNCH_COUNT = _build.launcher(_LIBRARY, _SIGNATURES,
                                "gb_masked_intersect_count", _ERROR)
_LAUNCH_FOLD = _build.launcher(_LIBRARY, _SIGNATURES,
                               "gb_masked_intersect_fold", _ERROR)
_LAUNCH_ORDERED = _build.launcher(_LIBRARY, _SIGNATURES,
                                  "gb_masked_intersect_fold_ordered", _ERROR)

# the kernel's codes for ⊕ (by monoid) and ⊗ (by operator name)
_ADD_CODE = {"PlusMonoid": 0, "MinimumMonoid": 1, "MaximumMonoid": 2,
             "LogicalOrMonoid": 3, "MultipliesMonoid": 4, "GreaterMonoid": 5,
             "CustomLessMonoid": 6, "NotEqualToMonoid": 7}
_MUL_CODE = {"plus": 0, "minus": 1, "multiplies": 2, "divides": 3,
             "greater": 4, "less": 5, "not_equal_to": 6, "select_second": 7,
             "logical_and": 8}
# the pairs csrc/masked_intersect.cu instantiates: the catalogue's
# semirings whose ⊕ is plus, min, max or logical or, then those folded in
# the JAX join's order
FOLD_SEMIRINGS = ("LogicalOrAnd", "PlusMultiplies", "MinimumPlus",
                  "MaximumMultiplies", "PlusDivides", "PlusGreater",
                  "PlusMinus", "PlusLess", "MinimumMultiplies",
                  "MinimumSelectSecond", "PlusNotEqualTo",
                  "MinimumNotEqualTo", "GreaterPlus", "CustomLessPlus",
                  "CustomLessLess", "NotEqualToPlus", "MultipliesMultiplies")
# the ⊕ whose fold repeats the JAX join's lanes and bracketing
ORDERED_ADDS = ("MultipliesMonoid", "GreaterMonoid", "CustomLessMonoid",
                "NotEqualToMonoid")
DTYPES = (torch.float32, torch.int32)
# scatter_reduce's reduction for each ⊕ (logical or: max of the 0/1 truths)
_REDUCE = {"PlusMonoid": "sum", "MinimumMonoid": "amin",
           "MaximumMonoid": "amax", "LogicalOrMonoid": "amax"}
# the ⊕ whose identity is not its neutral element
_MIN_MAX = ("MinimumMonoid", "MaximumMonoid")

# the least normal float32: the ordered folds flush values below it
_TINY = float(torch.finfo(torch.float32).tiny)
# the plain versions' expansion: at most this many lanes at once, fewer
# where the card's free memory asks for it (about this many bytes a lane
# in int64 temporaries)
PLAIN_CHUNK_LANES = 1 << 25
_PLAIN_BYTES_A_LANE = 128


def ordered(semiring) -> bool:
    """Whether the fold of `semiring` repeats the JAX join's order."""
    return semiring.add.name in ORDERED_ADDS


@functools.lru_cache(maxsize=None)
def _identity_bits(semiring, dtype: torch.dtype) -> int:
    """The semiring's identity in `dtype`, as the 32 bits the kernel takes."""
    ident = semiring.identity(dtype).reshape(1)
    return int(ident.view(torch.int32)) & 0xFFFFFFFF


def _neutral(add: str, dtype: torch.dtype) -> float:
    """⊕'s neutral element in `dtype`, where each fold starts."""
    if add not in _MIN_MAX:
        return 0
    if dtype.is_floating_point:
        lo, hi = float("-inf"), float("inf")
    else:
        lo, hi = torch.iinfo(dtype).min, torch.iinfo(dtype).max
    return hi if add == "MinimumMonoid" else lo


def _check(mi, mj, a_ptr, a_ind, b_ptr, b_ind, a_val=None, b_val=None):
    """Raise on operands the walk does not take."""
    idx = (mi, mj, a_ptr, a_ind, b_ptr, b_ind)
    if any(t.dtype != INDEX_DTYPE or t.dim() != 1 for t in idx):
        raise TypeError("mask ids, pointers and ids must be 1-D int32")
    if mi.shape != mj.shape:
        raise ValueError(f"{mi.shape[0]} mask row ids, {mj.shape[0]} "
                         "column ids")
    vals = [v for v in (a_val, b_val) if v is not None]
    if any(v.dim() != 1 for v in vals):
        raise ValueError("values must be 1-D")
    if a_val is not None and (a_val.shape[0] < a_ind.shape[0]
                              or b_val.shape[0] < b_ind.shape[0]):
        raise ValueError("values need an entry for each stored id")
    if any(t.device != mi.device for t in idx[1:] + tuple(vals)):
        raise ValueError("mask, A and B must be on one device")
    if not all(t.is_contiguous() for t in idx + tuple(vals)):
        raise ValueError("operands must be contiguous")


def _check_fold(semiring, dtype: torch.dtype, trace: bool = False,
                kernel: bool = True):
    """Raise unless T2 folds `semiring` on `dtype` (the kernel on float32
    and int32, the plain versions on any dtype the torch ops take).
    PlusDivides on int32 raises TypeError, as the JAX spgemm_masked does
    (its true division leaves int32); the trace of an ordered ⊕ raises
    NotImplementedError: the JAX trace folds it in XLA's reduce order over
    every stored entry, which no fixed order repeats."""
    if semiring.name == "PlusDivides" and dtype == torch.int32:
        raise TypeError("PlusDivides on int32: true division leaves int32, "
                        "as in the JAX spgemm_masked")
    if trace and ordered(semiring):
        raise NotImplementedError(
            f"no trace over {semiring.name}: the JAX trace folds "
            f"{semiring.add.name} in XLA's reduce order")
    if semiring.name not in FOLD_SEMIRINGS or (kernel and dtype not in
                                               DTYPES):
        raise NotImplementedError(
            f"no masked fold for {semiring.name} on {dtype}: T2 folds "
            f"{list(FOLD_SEMIRINGS)} on float32 and int32 (PlusDivides on "
            "float32)")


def _chunk_lanes(device: torch.device) -> int:
    if device.type != "cuda":
        return PLAIN_CHUNK_LANES
    free, _ = torch.cuda.mem_get_info(device)
    return max(1 << 16, min(PLAIN_CHUNK_LANES, free // _PLAIN_BYTES_A_LANE))


def _list_keys(ptr: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """int64 keys (list id << 32 | id) of every stored id, ascending."""
    nnz = int(ptr[-1])
    owner = torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, device=ptr.device), ptr[1:] - ptr[:-1],
        output_size=nnz)
    return (owner << 32) | ind[:nnz].long()


def _plain_matches(mi, mj, a_ptr, a_ind, b_ptr, b_ind):
    """Chunks of (mask edge, A position, B position) of every id the two
    lists of a mask edge share: A's lists expanded, each (j, k) looked up
    by torch.searchsorted among B's int64 keys (list id << 32 | id)."""
    dev = mi.device
    a_ptr, b_ptr = a_ptr.long(), b_ptr.long()
    mi64, mj64 = mi.long(), mj.long()
    nb = int(b_ptr[-1])
    if mi.shape[0] == 0 or nb == 0:
        return
    b_keys = _list_keys(b_ptr, b_ind)
    a_start = a_ptr[mi64]
    deg = a_ptr[mi64 + 1] - a_start
    ends = torch.cumsum(deg, 0)
    ends_host = ends.cpu()
    cap = _chunk_lanes(dev)
    s, m = 0, mi.shape[0]
    while s < m:
        base = int(ends_host[s - 1]) if s else 0
        t = int(torch.searchsorted(ends_host, base + cap, right=True))
        t = min(max(t, s + 1), m)
        lanes = int(ends_host[t - 1]) - base
        if lanes:
            d = deg[s:t]
            local = torch.repeat_interleave(torch.arange(t - s, device=dev),
                                            d, output_size=lanes)
            edge = local + s
            first = ends[s:t] - d - base     # each edge's first lane
            pos = a_start[edge] + torch.arange(lanes, device=dev) \
                - first[local]
            q = (mj64[edge] << 32) | a_ind[pos].long()
            hit = torch.searchsorted(b_keys, q).clamp_(max=nb - 1)
            found = b_keys[hit] == q
            yield edge[found], pos[found], hit[found]
        s = t


def _lookup(keys: torch.Tensor, q: torch.Tensor):
    """(position, found) of each query key q among the sorted keys."""
    if keys.shape[0] == 0:
        return torch.zeros_like(q), torch.zeros_like(q, dtype=torch.bool)
    hit = torch.searchsorted(keys, q).clamp_(max=keys.shape[0] - 1)
    return hit, keys[hit] == q


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to a zero of their sign (other dtypes as
    they are)."""
    if t.dtype != torch.float32:
        return t
    return torch.where(t.abs() < _TINY, torch.zeros_like(t).copysign(t), t)


class _Flushed:
    """A monoid whose results are flushed (`_flush`), for segmented_scan."""

    def __init__(self, monoid):
        self.monoid, self.name = monoid, monoid.name

    def __call__(self, a, b):
        return _flush(self.monoid(a, b))

    def identity(self, dtype):
        return self.monoid.identity(dtype)


def _ordered_fold_plain(mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val,
                        semiring) -> torch.Tensor:
    """The JAX join's fold (module docstring): each edge's lanes over the
    list it expands, the product or the identity, through
    segops.segmented_scan, one chunk of whole edges at a time."""
    dev, dtype, m = mi.device, a_val.dtype, mi.shape[0]
    ident = semiring.identity(dtype).item()
    c = torch.full((m,), ident, dtype=dtype, device=dev)
    if m == 0:
        return c
    a_ptr, b_ptr = a_ptr.long(), b_ptr.long()
    mi64, mj64 = mi.long(), mj.long()
    len_a = a_ptr[mi64 + 1] - a_ptr[mi64]
    len_b = b_ptr[mj64 + 1] - b_ptr[mj64]
    side_b = len_b < len_a                 # B's only when strictly shorter
    walk = torch.where(side_b, len_b, len_a)
    start = torch.where(side_b, b_ptr[mj64], a_ptr[mi64])
    a_keys, b_keys = _list_keys(a_ptr, a_ind), _list_keys(b_ptr, b_ind)
    ends = torch.cumsum(walk, 0)
    ends_host = ends.cpu()
    cap = _chunk_lanes(dev)
    s = 0
    while s < m:
        base = int(ends_host[s - 1]) if s else 0
        t = int(torch.searchsorted(ends_host, base + cap, right=True))
        t = min(max(t, s + 1), m)
        lanes = int(ends_host[t - 1]) - base
        if lanes:
            d = walk[s:t]
            local = torch.repeat_interleave(torch.arange(t - s, device=dev),
                                            d, output_size=lanes)
            edge = local + s
            first = ends[s:t] - d - base       # each edge's first lane
            pos = start[edge] + torch.arange(lanes, device=dev) \
                - first[local]
            sb = side_b[edge]
            ids = torch.empty(lanes, dtype=torch.int64, device=dev)
            ids[~sb] = a_ind[pos[~sb]].long()
            ids[sb] = b_ind[pos[sb]].long()
            # look each walked id up in the other side's list
            a_pos, b_pos = pos.clone(), pos.clone()
            hit_b, in_b = _lookup(b_keys, (mj64[edge] << 32) | ids)
            hit_a, in_a = _lookup(a_keys, (mi64[edge] << 32) | ids)
            b_pos[~sb], a_pos[sb] = hit_b[~sb], hit_a[sb]
            found = torch.where(sb, in_a, in_b)
            lane = torch.full((lanes,), ident, dtype=dtype, device=dev)
            lane[found] = _flush(semiring.mul(
                _flush(a_val[a_pos[found]]),
                _flush(b_val[b_pos[found]])).to(dtype))
            heads = torch.zeros(lanes, dtype=torch.bool, device=dev)
            nonempty = d > 0
            heads[first[nonempty]] = True
            scanned = segmented_scan(lane, heads, _Flushed(semiring.add))
            tails = (first + d - 1)[nonempty]
            c[s + torch.nonzero(nonempty).flatten()] = scanned[tails]
        s = t
    return c


def masked_intersect_count_plain(mi, mj, a_ptr, a_ind, b_ptr, b_ind) -> int:
    """Plain PyTorch version of T1."""
    _check(mi, mj, a_ptr, a_ind, b_ptr, b_ind)
    return sum(int(e.shape[0]) for e, _, _ in
               _plain_matches(mi, mj, a_ptr, a_ind, b_ptr, b_ind))


def masked_intersect_fold_plain(mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind,
                                b_val, semiring,
                                trace: bool = False) -> torch.Tensor:
    """Plain PyTorch version of T2, in a_val's dtype (any dtype the torch
    ops take): the products of the matches, ⊗ with A's value first,
    scatter-reduced into ⊕'s neutral element; then ⊕ the identity where
    the module's rule joins it (`trace`: the trace's rule)."""
    _check(mi, mj, a_ptr, a_ind, b_ptr, b_ind, a_val, b_val)
    dtype = a_val.dtype
    _check_fold(semiring, dtype, trace, kernel=False)
    b_val = b_val.to(dtype)
    if ordered(semiring):
        return _ordered_fold_plain(mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind,
                                   b_val, semiring)
    add = semiring.add.name
    m = mi.shape[0]
    c = torch.full((m,), _neutral(add, dtype), dtype=dtype, device=mi.device)
    hits = torch.zeros(m, dtype=torch.int64, device=mi.device)
    for edge, a_pos, b_pos in _plain_matches(mi, mj, a_ptr, a_ind, b_ptr,
                                             b_ind):
        prod = semiring.mul(a_val[a_pos], b_val[b_pos])
        if add == "LogicalOrMonoid":
            prod = prod != 0
        c.scatter_reduce_(0, edge, prod.to(dtype), _REDUCE[add],
                          include_self=True)
        hits += torch.bincount(edge, minlength=m)
    if add in _MIN_MAX and m:
        mi64, mj64 = mi.long(), mj.long()
        len_a = (a_ptr[mi64 + 1] - a_ptr[mi64]).long()
        len_b = (b_ptr[mj64 + 1] - b_ptr[mj64]).long()
        miss = (hits < len_a if trace
                else (hits < torch.minimum(len_a, len_b)) | (hits == 0))
        ident = semiring.identity(dtype).to(mi.device)
        c = torch.where(miss, semiring.add(c, ident), c)
    return c


def _schedule(mi, mj, a_ptr, a_ind, b_ptr, b_ind, sched, fold: bool):
    """`sched`, checked against the operands, or where it is None one
    built for them (ids below the largest stored id + 1)."""
    if sched is None:
        tops = [int(ind[: int(ptr[-1])].max()) + 1
                for ptr, ind in ((a_ptr, a_ind), (b_ptr, b_ind))
                if int(ptr[-1])]
        return build_intersect_schedule(mi, mj, a_ptr, b_ptr,
                                        max(tops, default=0), fold)
    if not isinstance(sched, IntersectSchedule) or sched.edges != \
            mi.shape[0] or sched.bitmap.device != mi.device:
        raise ValueError("the schedule was built for other operands")
    if fold and not sched.fold:
        raise ValueError("T2 needs a schedule built for the fold")
    return sched


def _count_routes(fn, sched: IntersectSchedule) -> None:
    fn.launches += 1
    for route, edges in sched.routes.items():
        fn.routes[route] += edges


def masked_intersect_count(mi, mj, a_ptr, a_ind, b_ptr, b_ind,
                           sched=None) -> int:
    """T1: Σ over the mask edges of |la ∩ lb|, a Python int read from the
    card once. CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream over `sched` (built here when None), or
    raise."""
    if mi.device.type == "cpu":
        return masked_intersect_count_plain(mi, mj, a_ptr, a_ind, b_ptr,
                                            b_ind)
    _check(mi, mj, a_ptr, a_ind, b_ptr, b_ind)
    if mi.device.type != "cuda":
        raise ValueError(f"no masked intersection for device {mi.device}")
    if mi.shape[0] == 0:      # a zero-size grid is an invalid launch
        return 0
    sched = _schedule(mi, mj, a_ptr, a_ind, b_ptr, b_ind, sched, False)
    total = torch.empty(1, dtype=torch.int64, device=mi.device)
    _LAUNCH_COUNT(mi.get_device(), mi.data_ptr(), mj.data_ptr(),
                  a_ptr.data_ptr(), a_ind.data_ptr(), b_ptr.data_ptr(),
                  b_ind.data_ptr(), sched.arg, total.data_ptr())
    _count_routes(masked_intersect_count, sched)
    return int(total.item())


def masked_intersect_fold(mi, mj, a_ptr, a_ind, a_val, b_ptr, b_ind, b_val,
                          semiring, trace: bool = False,
                          sched=None) -> torch.Tensor:
    """T2: c[e] = ⊕_{k ∈ la ∩ lb} a_val ⊗ b_val with ⊕'s identity joined
    by the masked mxm's rule, or the trace's where `trace` (module
    docstring); (m,) of a_val's dtype; b_val is cast to it. CPU tensors run
    the plain version; CUDA tensors launch the kernel on the current
    stream over `sched` (built for the fold here when None), or raise
    (NotImplementedError for a semiring or dtype it does not fold). An
    ordered ⊕ launches the ordered fold, which reads no schedule, and
    counts in `.ordered_launches` in place of `.launches`."""
    if mi.device.type == "cpu":
        return masked_intersect_fold_plain(mi, mj, a_ptr, a_ind, a_val,
                                           b_ptr, b_ind, b_val, semiring,
                                           trace)
    _check(mi, mj, a_ptr, a_ind, b_ptr, b_ind, a_val, b_val)
    if mi.device.type != "cuda":
        raise ValueError(f"no masked intersection for device {mi.device}")
    dtype = a_val.dtype
    _check_fold(semiring, dtype, trace)
    if b_val.dtype != dtype:
        b_val = b_val.to(dtype)
    m = mi.shape[0]
    c = torch.empty(m, dtype=dtype, device=mi.device)
    if m == 0:
        return c
    if ordered(semiring):
        _LAUNCH_ORDERED(mi.get_device(), mi.data_ptr(), mj.data_ptr(),
                        a_ptr.data_ptr(), a_ind.data_ptr(), a_val.data_ptr(),
                        b_ptr.data_ptr(), b_ind.data_ptr(), b_val.data_ptr(),
                        m, c.data_ptr(), _ADD_CODE[semiring.add.name],
                        _MUL_CODE[semiring.mul.name],
                        int(dtype == torch.float32),
                        _identity_bits(semiring, dtype))
        masked_intersect_fold.ordered_launches += 1
        return c
    sched = _schedule(mi, mj, a_ptr, a_ind, b_ptr, b_ind, sched, True)
    _LAUNCH_FOLD(mi.get_device(), mi.data_ptr(), mj.data_ptr(),
                 a_ptr.data_ptr(), a_ind.data_ptr(), a_val.data_ptr(),
                 b_ptr.data_ptr(), b_ind.data_ptr(), b_val.data_ptr(),
                 sched.arg, c.data_ptr(), _ADD_CODE[semiring.add.name],
                 _MUL_CODE[semiring.mul.name], int(dtype == torch.float32),
                 _identity_bits(semiring, dtype), int(trace))
    _count_routes(masked_intersect_fold, sched)
    return c


masked_intersect_count.launches = 0
masked_intersect_fold.launches = 0
masked_intersect_fold.ordered_launches = 0
masked_intersect_count.routes = {"bitmap": 0, "search": 0}
masked_intersect_fold.routes = {"bitmap": 0, "search": 0}
