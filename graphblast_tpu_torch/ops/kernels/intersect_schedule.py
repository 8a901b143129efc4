"""The intersection schedule: how T1 and T2 (csrc/masked_intersect.cu)
spread a mask's edges over the card, and which route each edge takes.

For mask edge e = (i, j), la is A's row i and lb is B's list j; every edge
of mask row i shares la. Two routes, costed in eighths of an L1 wavefront
(a 128-byte shared-memory or L1 access of one warp):

  search: the warp strides the shorter list (w ids) and binary-searches the
      longer (l ids); each search takes about bit_length(l) halvings, the
      last three inside one 32-byte sector, so
          search(e) = SEARCH_SECTOR · w · max(1, bit_length(l) − 3);
  bitmap: the block writes la into a bitmap of n_ids bits in shared memory
      once for the row, and the warp streams lb against it:
          bitmap(e) = BITMAP_ID · |lb| + (STAGE_ID · |la| + PIECE) / r,
      r being the edges of e's mask row (the staging is shared across it).

An edge takes the bitmap route where bitmap(e) < search(e) and the bitmap
fits SMEM_BUDGET (n_ids / 8 bytes for T1, twice that for T2, whose prefix
counts give each hit's position in la); else the search route. Each edge
then costs EDGE plus its route's cost. Work units, one block each, are runs
of consecutive mask rows cut where the cumulative cost passes the unit
target, min(UNIT_COST, total cost / MIN_UNITS rounded up): a row starts
the unit floor(cost before it / target); a row whose cost alone passes the
target is cut at its edges the same way, and each of its pieces stages la
itself. "Rows" are runs of equal mask row ids, so any
mask order is taken (a CSR mask's runs are its rows).

The schedule depends on the lengths only (mi, mj and the pointers), so one
serves every semiring; ops/spgemm.py caches it in the mask's plans. It is
built with torch ops on the operands' device, with a few reads of sizes to
the host, and nothing in it changes after it is built.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...types import INDEX_DTYPE

# the costs, in eighths of an L1 wavefront. BITMAP_ID and PIECE were chosen
# by timing T1 and T2 at RMAT scale 18 on an H100 over BITMAP_ID 1 to 12
# and PIECE 512 to 65,536 (PERF.md, section 6)
SEARCH_SECTOR = 8   # one probed 32-byte sector of a binary search
BITMAP_ID = 2       # one coalesced id of lb (1/8) and its bit test (1/8)
STAGE_ID = 4        # one id of la: a coalesced read, atomicOr, and clear
PIECE = 16384       # a bitmap piece: its block barriers and idle warps
EDGE = 8            # any edge: its mask entry and four pointers
# a work unit's target cost: about 65,536 wavefronts, or less where the
# mask would then make fewer than MIN_UNITS units (8 blocks an SM of an
# H100's 132), so that a light mask still fills the card
UNIT_COST = 8 * 65536
MIN_UNITS = 8 * 132
# the bitmap (and T2's prefix counts) a block may hold: kSmemBudget of
# csrc/masked_intersect.cu, two blocks an SM of 227 KB
SMEM_BUDGET = 112 * 1024


class _CSchedule(ctypes.Structure):
    """struct Schedule of csrc/masked_intersect.cu."""
    _fields_ = [("search_edges", ctypes.c_void_p),
                ("unit_search", ctypes.c_void_p),
                ("bitmap_edges", ctypes.c_void_p),
                ("piece_begin", ctypes.c_void_p),
                ("unit_piece", ctypes.c_void_p),
                ("units", ctypes.c_longlong),
                ("words", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class IntersectSchedule:
    """What `build_intersect_schedule` returns, on the operands' device.
    `bitmap` (bool, m) is each edge's route. Unit u takes the search edges
    search_edges[unit_search[u]:unit_search[u + 1]] and the pieces
    unit_piece[u] .. unit_piece[u + 1] - 1; piece p is the bitmap edges
    bitmap_edges[piece_begin[p]:piece_begin[p + 1]], all of one mask row
    and in edge order. `words` is the bitmap's 32-bit words, 0 where no
    edge takes the bitmap route; `fold` whether it was built for T2 (its
    bitmap budget counts the prefix counts too)."""

    bitmap: torch.Tensor
    search_edges: torch.Tensor
    unit_search: torch.Tensor
    bitmap_edges: torch.Tensor
    piece_begin: torch.Tensor
    unit_piece: torch.Tensor
    n_ids: int
    words: int
    fold: bool
    target: int

    def __post_init__(self):
        c = _CSchedule(self.search_edges.data_ptr(),
                       self.unit_search.data_ptr(),
                       self.bitmap_edges.data_ptr(),
                       self.piece_begin.data_ptr(),
                       self.unit_piece.data_ptr(), self.units, self.words)
        object.__setattr__(self, "_c", c)
        # the kernels' schedule argument: the address of the host struct
        object.__setattr__(self, "arg", ctypes.addressof(c))

    @property
    def edges(self) -> int:
        return self.bitmap.shape[0]

    @property
    def units(self) -> int:
        return self.unit_search.shape[0] - 1

    @property
    def pieces(self) -> int:
        return self.piece_begin.shape[0] - 1

    @property
    def routes(self) -> dict:
        """Edges on each route."""
        nb = self.bitmap_edges.shape[0]
        return {"bitmap": nb, "search": self.edges - nb}


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """bit_length of each int64 x >= 0, exactly: frexp's exponent."""
    return torch.frexp(x.double())[1].long()


def edge_costs(mi, mj, a_ptr, b_ptr):
    """(search, bitmap · r, r, row) per mask edge, int64, by the module's
    formulas: bitmap · r is the bitmap route's cost times r, the edges of
    the edge's mask row, so that every comparison stays in integers; row
    numbers the runs of equal mask row ids from 0."""
    dev = mi.device
    m = mi.shape[0]
    mi64, mj64 = mi.long(), mj.long()
    la = (a_ptr[mi64 + 1] - a_ptr[mi64]).long()
    lb = (b_ptr[mj64 + 1] - b_ptr[mj64]).long()
    halvings = _bit_length(torch.maximum(la, lb))
    search = SEARCH_SECTOR * torch.minimum(la, lb) * (halvings - 3).clamp(
        min=1)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = mi[1:] != mi[:-1]
    run = torch.cumsum(head, 0) - 1
    r = torch.bincount(run)[run] if m else run
    bitmap_r = BITMAP_ID * lb * r + STAGE_ID * la + PIECE
    return search, bitmap_r, r, run


def _offsets(owner: torch.Tensor, n: int) -> torch.Tensor:
    """int32 (n + 1,) offsets of the groups 0 .. n - 1 of an ascending
    owner id list."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=owner.device)
    out[1:] = torch.cumsum(torch.bincount(owner, minlength=n), 0)
    return out.to(INDEX_DTYPE)


def build_intersect_schedule(mi, mj, a_ptr, b_ptr, n_ids: int, fold: bool,
                             budget: int = SMEM_BUDGET,
                             unit_cost: int = UNIT_COST,
                             all_bitmap: bool = False) -> IntersectSchedule:
    """The schedule of the mask edges (mi, mj) over A's pointers a_ptr and
    B's b_ptr (module docstring), for ids below n_ids; `fold` for T2.
    `budget` (bytes of shared memory) and `unit_cost` (eighths of a
    wavefront, the most a unit's target may be) are the kernel's, and
    `all_bitmap` sends every edge down the bitmap route where it fits,
    whatever it costs: the tests' way to hold both routes to the same
    results on small graphs."""
    dev = mi.device
    m = mi.shape[0]
    if m >= 1 << 31:
        raise ValueError(f"{m} mask edges: the schedule holds int32 ids")
    words = -(-n_ids // 32)
    fits = words * (8 if fold else 4) <= budget
    search, bitmap_r, r, run = edge_costs(mi, mj, a_ptr, b_ptr)
    bitmap = ((bitmap_r < search * r) | all_bitmap) & fits
    cost = EDGE + torch.where(bitmap, -(-bitmap_r // r.clamp(min=1)), search)
    before = torch.cumsum(cost, 0) - cost
    target = unit_cost
    if m:
        target = min(unit_cost, -(-int(before[-1] + cost[-1]) // MIN_UNITS))
        row_cost = torch.zeros(int(run[-1]) + 1, dtype=torch.int64,
                               device=dev).index_add_(0, run, cost)
        big = row_cost[run] > target
        row_head = torch.ones(m, dtype=torch.bool, device=dev)
        row_head[1:] = run[1:] != run[:-1]
        first = before[row_head]        # the cost before each row
        key = torch.where(big, before, first[run]) // target
        head = torch.ones(m, dtype=torch.bool, device=dev)
        head[1:] = key[1:] != key[:-1]
        unit = torch.cumsum(head, 0) - 1
        units = int(unit[-1]) + 1
    else:
        unit = run
        units = 0
    search_edges = torch.nonzero(~bitmap).flatten()
    bitmap_edges = torch.nonzero(bitmap).flatten()
    nb = bitmap_edges.shape[0]
    bu, br = unit[bitmap_edges], run[bitmap_edges]
    piece_head = torch.ones(nb, dtype=torch.bool, device=dev)
    piece_head[1:] = (bu[1:] != bu[:-1]) | (br[1:] != br[:-1])
    starts = torch.nonzero(piece_head).flatten()
    piece_begin = torch.full((starts.shape[0] + 1,), nb, dtype=INDEX_DTYPE,
                             device=dev)
    piece_begin[:-1] = starts
    return IntersectSchedule(
        bitmap=bitmap,
        search_edges=search_edges.to(INDEX_DTYPE),
        unit_search=_offsets(unit[search_edges], units),
        bitmap_edges=bitmap_edges.to(INDEX_DTYPE),
        piece_begin=piece_begin,
        unit_piece=_offsets(bu[starts], units),
        n_ids=n_ids, words=words if nb else 0, fold=fold, target=target)
