// The row schedule's walk, shared by the pulls that read a CSR row by row
// and fold each row's edges into one value: the value pull (K2/K3,
// value_pull.cu), the monoid pull (K4, monoid_pull.cu), the bitmap pull
// (K1, bitmap_pull.cu) and the min/max row fold of the plan-less pull (S,
// minmax_pull.cu).
//
// Rows are binned by length L once per sparsity structure
// (ops/kernels/row_schedule.py build_schedule, torch ops on the plan's
// device), and the kernels read rows through `perm`, the rows stably sorted
// by bin:
//   - long rows, L > T: each is one thread-block cluster (Hopper) of 8
//     blocks, and block j of the cluster folds the row's j-th eighth, its
//     chunk (a fixed tree: each thread's strided edges in order, a warp
//     shuffle, the 8 warp results in order) into its shared memory. After a
//     cluster barrier block 0 reads the 8 chunk results through distributed
//     shared memory and folds them in chunk order. Blocks run in no order
//     and float atomics would make two launches differ; here every fold has
//     a fixed order, so two launches are bitwise equal. The partial results
//     never leave the cluster: no scratch in device memory and no state
//     kept between calls, so calls over one schedule may overlap. The
//     clusters are a launch of their own (a cluster shape on the whole grid
//     slowed its other blocks, which need no cluster), and the grid of the
//     other bins follows as a programmatic dependent launch: it starts once
//     every cluster block has started, runs beside them, and each of its
//     blocks waits for the cluster grid only at its end, so that work after
//     the call sees every row. The hub row (25,077 edges at RMAT scale 18)
//     runs on 8 SMs, about 3,100 edges each;
//   - medium rows, 32 < L <= T: one warp strides the row;
//   - short rows, L <= 32: a group of g lanes a row, g the power of two
//     from 4 to 32 that is at least L, so a warp serves 32/g rows with
//     every lane on an edge. Empty rows sit in the 4-lane bin and get the
//     fold's identity, or the policy's empty_row().
// The second grid's blocks map to work by bin: the medium rows (8 a
// block), then the four short bins (8 * 32/g rows a block). A thread's
// strided loop takes four edges an iteration: four reads of ind, then the
// four edges' other reads, all in flight at once, then four folds in edge
// order. T = 8192 (row_schedule.py LONG_ROW), from a sweep of T and of a
// fixed chunk length over 2048 .. 16384 at RMAT scale 18 on an H100 in an
// earlier design of the value pull (PERF.md).
//
// A kernel gives the walk a policy P, an object passed by value to the
// kernels, with
//   using Acc;                      the accumulator (and y's element) type
//   using Item;                     what one edge's reads give
//   Acc identity()                  the fold's identity: every fold starts
//                                   there, and an empty row keeps it
//   Item fetch(int j, long long e)  edge e's reads, j = ind[e]
//   Acc add(Acc acc, Item it)       acc folded with edge `it`
//   static Acc combine(Acc, Acc)    two partial results folded (warp
//                                   shuffles, warp results, chunk results)
// and, optionally,
//   Acc empty_row()                 a row with no edges, where that is not
//                                   the fold's identity
//   bool row_open(int row)          whether row `row` is folded at all
//                                   (a mask): a row that is not is written
//                                   identity(), and none of its ptr or ind
//                                   is read
//   bool saturated(Acc acc)         whether no further edge can change acc:
//                                   a long row's block stops its chunk
//                                   once a lane of it holds a saturated
//                                   acc after a step (an edge a lane;
//                                   its other warps at their next step),
//                                   and with row_open() a
//                                   medium row's warp after its first
//                                   such step, a row of 9 to 32 edges
//                                   after its first such 8-id sub-step, so
//                                   combine() must give a saturated result
//                                   from a saturated part, whatever the
//                                   other
// all __device__ and const where they are members. With row_open() a long
// row's cluster reads the row's entry first and leaves together when it
// is closed, and the other bins are taken up to kWarpRows rows a warp
// (open_rows): the warp reads its rows' entries at once, writes the closed
// ones, and folds only the open ones, packed; `launch` sizes that grid
// from the bins' rows. A policy without a hook compiles to the walk it had
// before the hooks: each test sits behind `if constexpr`. `launch<P>` runs
// the two grids on a stream.
//
// Needs sm_90 (clusters, distributed shared memory, griddepcontrol).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>

namespace row_schedule {

namespace cg = cooperative_groups;

// whether policy P gives empty_row()
template <class P, class = void>
struct has_empty_row : std::false_type {};
template <class P>
struct has_empty_row<P, std::void_t<decltype(std::declval<const P&>()
                                                 .empty_row())>>
    : std::true_type {};

// whether policy P gives row_open(row)
template <class P, class = void>
struct has_row_open : std::false_type {};
template <class P>
struct has_row_open<P, std::void_t<decltype(std::declval<const P&>()
                                                .row_open(0))>>
    : std::true_type {};

// whether policy P gives saturated(acc)
template <class P, class = void>
struct has_saturated : std::false_type {};
template <class P>
struct has_saturated<P, std::void_t<decltype(std::declval<const P&>().saturated(
                            std::declval<typename P::Acc>()))>>
    : std::true_type {};

constexpr int kCluster = 8;   // blocks (chunks) of a long row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 6;   // long, medium, then groups of 32, 16, 8, 4 lanes

// The schedule's sizes, copied from the host: blocks [block_begin[b],
// block_begin[b + 1]) serve bin b, whose rows are perm[row_begin[b] ..
// row_begin[b + 1]); bin 0's blocks are its chunks, kCluster a row.
struct Sched {
  int block_begin[kBins + 1];
  int row_begin[kBins + 1];
};

// `meta` is a host array of 2 * (kBins + 1) ints: block_begin, then
// row_begin (whose last entry is n_out)
inline Sched sched_of(const int* meta) {
  Sched s;
  for (int b = 0; b <= kBins; ++b) {
    s.block_begin[b] = meta[b];
    s.row_begin[b] = meta[kBins + 1 + b];
  }
  return s;
}

// acc folded with edges e, e + kStep, e + 2 kStep, ... below end, in that
// order; four edges an iteration, so that four reads of ind and then the
// four edges' other reads are in flight at once
template <class P, int kStep>
__device__ __forceinline__ typename P::Acc strided_fold(
    const P& p, const int32_t* __restrict__ ind, long long e, long long end,
    typename P::Acc acc) {
  for (; e + 3 * kStep < end; e += 4 * kStep) {
    int j[4];
    typename P::Item it[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) j[u] = __ldg(ind + e + u * kStep);
#pragma unroll
    for (int u = 0; u < 4; ++u) it[u] = p.fetch(j[u], e + u * kStep);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = p.add(acc, it[u]);
  }
  for (; e < end; e += kStep) acc = p.add(acc, p.fetch(__ldg(ind + e), e));
  return acc;
}

// The strided fold of a policy with saturated(): thread t of the kStep
// threads that share edges [beg, end) folds edges beg + t, beg + t +
// kStep, ..., one a step, and the warp stops after the first step at which
// any of its lanes holds a saturated acc or *stop is set; a warp that
// stops sets *stop (where stop is given), so that the other warps of its
// block stop too. Every lane runs the same steps, so that each vote has
// the whole warp: the warp's threads must have consecutive t. One edge a
// lane a step took 4-6% less than strided_fold's four in K1's masked BFS
// pulls at Kronecker and uniform scale 25 on an H100 (PERF.md).
template <class P, int kStep>
__device__ __forceinline__ typename P::Acc stopping_fold(
    const P& p, const int32_t* __restrict__ ind, long long beg, long long end,
    int t, typename P::Acc acc, volatile int* stop) {
  for (long long e = beg + t; e - t < end; e += kStep) {
    if (e < end) acc = p.add(acc, p.fetch(__ldg(ind + e), e));
    const bool done = p.saturated(acc) || (stop != nullptr && *stop);
    if (__any_sync(0xffffffffu, done)) {
      if (stop != nullptr) *stop = 1;
      break;
    }
  }
  return acc;
}

// the fold over lanes [0, width) of each group of `width` lanes, in lane 0
template <class P, int kWidth>
__device__ __forceinline__ typename P::Acc group_fold(typename P::Acc acc) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    acc = P::combine(acc, __shfl_down_sync(0xffffffffu, acc, off, kWidth));
  return acc;
}

// block b of the long bin: chunk b % kCluster of long row b / kCluster,
// edges chunk_beg[b] .. the next chunk's start (the row's end for the
// last); the cluster's block 0 writes the row's y
template <class P>
__device__ void long_chunk(const P& p, const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           typename P::Acc* __restrict__ y,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ chunk_beg, int b) {
  using Acc = typename P::Acc;
  __shared__ Acc warp_part[kWarps];
  __shared__ Acc chunk_part;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = b % kCluster;
  const int row = __ldg(perm + b / kCluster);
  if constexpr (has_row_open<P>::value) {
    // every block of the cluster reads the one entry and leaves, so that
    // none waits at a cluster barrier
    if (!p.row_open(row)) {
      if (j == 0 && threadIdx.x == 0) y[row] = p.identity();
      return;
    }
  }
  const long long beg = __ldg(chunk_beg + b);
  const long long end = j + 1 < kCluster ? __ldg(chunk_beg + b + 1)
                                         : __ldg(ptr + row + 1);
  Acc acc;
  if constexpr (has_saturated<P>::value) {
    __shared__ int stop;   // set by the first of the block's warps to stop
    if (threadIdx.x == 0) stop = 0;
    __syncthreads();
    acc = stopping_fold<P, kThreads>(p, ind, beg, end, threadIdx.x,
                                     p.identity(), &stop);
  } else {
    acc = strided_fold<P, kThreads>(p, ind, beg + threadIdx.x, end,
                                    p.identity());
  }
  acc = group_fold<P, 32>(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc total = p.identity();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = P::combine(total, warp_part[w]);
    chunk_part = total;
  }
  cluster.sync();   // every chunk's result is in its block's shared memory
  if (j == 0 && threadIdx.x == 0) {
    Acc total = p.identity();
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      total = P::combine(total, *cluster.map_shared_rank(&chunk_part, r));
    y[row] = total;
  }
  cluster.sync();   // no block leaves while block 0 reads its shared memory
}

template <class P>
__device__ void warp_row(const P& p, const int32_t* __restrict__ ptr,
                         const int32_t* __restrict__ ind,
                         typename P::Acc* __restrict__ y, int row) {
  const int lane = threadIdx.x & 31;
  const long long beg = __ldg(ptr + row);
  const long long end = __ldg(ptr + row + 1);
  typename P::Acc acc =
      strided_fold<P, 32>(p, ind, beg + lane, end, p.identity());
  acc = group_fold<P, 32>(acc);
  if (lane == 0) {
    if constexpr (has_empty_row<P>::value)
      y[row] = beg < end ? acc : p.empty_row();
    else
      y[row] = acc;
  }
}

// 32/G rows a warp, G lanes a row of at most G edges
template <class P, int G>
__device__ void group_rows(const P& p, const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           typename P::Acc* __restrict__ y,
                           const int32_t* __restrict__ perm, long long first,
                           int row_end) {
  const int lane = threadIdx.x & 31;
  if (first >= row_end) return;   // whole warps leave together
  const long long k = first + lane / G;
  int row = -1;
  bool edge = false;   // in the group's lane 0: whether the row has an edge
  typename P::Acc acc = p.identity();
  if (k < row_end) {
    row = __ldg(perm + k);
    const long long e = __ldg(ptr + row) + lane % G;
    edge = e < __ldg(ptr + row + 1);
    if (edge) acc = p.add(p.identity(), p.fetch(__ldg(ind + e), e));
  }
  acc = group_fold<P, G>(acc);
  if (lane % G == 0 && row >= 0) {
    if constexpr (has_empty_row<P>::value)
      y[row] = edge ? acc : p.empty_row();
    else
      y[row] = acc;
  }
}

// The bins of short and medium rows under a policy with row_open(): a
// warp takes n_rows consecutive rows of bin `bin` (from perm[first]), a
// lane a row, reads their entries at once and writes identity() to the
// closed ones; then it folds the open ones, packed by their rank among
// the open rows so that a step has no closed row while open ones remain: a
// warp a row in the medium bin (the stopping fold, with saturated()), 8
// lanes a row in the bins of 9 to 32 edges (8 ids a sub-step, stopping
// with saturated()), 32/G rows a step in the bins of G = 8 and 4 lanes. A
// closed row costs a lane's reads of perm and the mask and its write of y,
// whatever its bin.
constexpr int kWarpRows = 32;
// Since a warp folds its open rows one after another, a warp takes fewer
// rows where the bins have too few rows to keep kMinWarps warps, about 4
// waves of 64 warps on 132 SMs. On an H100 a pull-only BFS's five pulls
// from the hub of RMAT scale 18 (262,144 rows, 8 a warp) took 0.172 ms,
// against 0.190 for K1's count, 0.211 with 32 rows a warp at any size and
// 0.245 with kMinWarps 2^17 (2 a warp); at scale 25 the four gave the same
// (PERF.md)
constexpr int kMinWarps = 1 << 15;

// the rows a warp of bin `bin` (1 .. 5) takes under a policy with
// row_open(): as many as keep kMinWarps warps on bins 1 .. 5, up to
// kWarpRows, and at least a step's (open_rows): 4 in the bins of 9 to 32
// edges, 32/G in those of G = 8 and 4 lanes
__host__ __device__ inline int open_warp_rows(const Sched& s, int bin) {
  const int rows = s.row_begin[kBins] - s.row_begin[1];
  int r = kWarpRows;
  while (r > 1 && rows / r < kMinWarps) r >>= 1;
  const int step = bin == 1 ? 1 : bin <= 3 ? 4 : 1 << (bin - 2);
  return r > step ? r : step;
}

template <class P>
__device__ void open_rows(const P& p, const int32_t* __restrict__ ptr,
                          const int32_t* __restrict__ ind,
                          typename P::Acc* __restrict__ y,
                          const int32_t* __restrict__ perm, int bin,
                          int n_rows, long long first, int row_end) {
  static_assert(!has_empty_row<P>::value,
                "a closed row and an empty one are both written identity()");
  // the warp's open rows and their edges, by rank
  __shared__ int open_row[kWarps][kWarpRows];
  __shared__ int open_beg[kWarps][kWarpRows];
  __shared__ int open_end[kWarps][kWarpRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (first >= row_end) return;   // whole warps leave together
  const long long k = first + lane;
  bool open = false;
  int row = 0;
  if (lane < n_rows && k < row_end) {
    row = __ldg(perm + k);
    open = p.row_open(row);
    if (!open) y[row] = p.identity();
  }
  const unsigned opened = __ballot_sync(0xffffffffu, open);
  if (open) {
    const int rank = __popc(opened & ((1u << lane) - 1u));
    open_row[warp][rank] = row;
    open_beg[warp][rank] = __ldg(ptr + row);
    open_end[warp][rank] = __ldg(ptr + row + 1);
  }
  __syncwarp();
  const int n_open = __popc(opened);
  using Acc = typename P::Acc;
  if (bin == 1) {
    for (int i = 0; i < n_open; ++i) {
      const long long beg = open_beg[warp][i];
      const long long end = open_end[warp][i];
      Acc acc;
      if constexpr (has_saturated<P>::value)
        acc = stopping_fold<P, 32>(p, ind, beg, end, lane, p.identity(),
                                   nullptr);
      else
        acc = strided_fold<P, 32>(p, ind, beg + lane, end, p.identity());
      acc = group_fold<P, 32>(acc);
      if (lane == 0) y[open_row[warp][i]] = acc;
    }
    return;
  }
  if (bin == 2 || bin == 3) {
    // rows of 9 to 32 edges: 8 lanes a row, 4 rows a step, 8 ids a
    // sub-step, a row's group stopping after the sub-step that saturates
    // it (saturated()); on an H100 K1's masked BFS pulls at uniform scale
    // 25 took 17% less than with a row's every edge read at once (PERF.md)
    const int sub = lane & 7;
    const unsigned group = 0xffu << (lane & ~7);
    const int top = bin == 2 ? 32 : 16;
    for (int i0 = 0; i0 < n_open; i0 += 4) {
      const int i = i0 + (lane >> 3);
      const bool has = i < n_open;
      const long long beg = has ? open_beg[warp][i] : 0;
      const long long end = has ? open_end[warp][i] : 0;
      Acc acc = p.identity();
      bool done = false;
      for (int off = 0; off < top; off += 8) {
        const long long e = beg + off + sub;
        if (!done && e < end) acc = p.add(acc, p.fetch(__ldg(ind + e), e));
        if constexpr (has_saturated<P>::value)
          done = (__ballot_sync(0xffffffffu, p.saturated(acc)) & group) != 0;
        if (!__any_sync(0xffffffffu, !done && beg + off + 8 < end)) break;
      }
      acc = group_fold<P, 8>(acc);
      if (has && sub == 0) y[open_row[warp][i]] = acc;
    }
    return;
  }
  // rows of at most 8 edges: bin 2 + j has groups of 32 >> j lanes
  const int g_log = 7 - bin;   // log2 of the group's lanes
  for (int i0 = 0; i0 < n_open; i0 += 32 >> g_log) {
    const int i = i0 + (lane >> g_log);
    Acc acc = p.identity();
    if (i < n_open) {
      const long long e = open_beg[warp][i] + (lane & ((1 << g_log) - 1));
      if (e < open_end[warp][i])
        acc = p.add(acc, p.fetch(__ldg(ind + e), e));
    }
    if (bin == 4)
      acc = group_fold<P, 8>(acc);
    else
      acc = group_fold<P, 4>(acc);
    if (i < n_open && (lane & ((1 << g_log) - 1)) == 0)
      y[open_row[warp][i]] = acc;
  }
}

// the long rows: a cluster of kCluster blocks a row
template <class P>
__global__ void __launch_bounds__(kThreads)
long_rows_kernel(const int32_t* __restrict__ ptr,
                 const int32_t* __restrict__ ind,
                 typename P::Acc* __restrict__ y,
                 const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ chunk_beg, const P p) {
  // the grid of the other bins may start beside this one
  asm volatile("griddepcontrol.launch_dependents;");
  long_chunk<P>(p, ptr, ind, y, perm, chunk_beg, (int)blockIdx.x);
}

// block b of bins 1 .. 5, numbered as in the schedule
template <class P>
__device__ void other_rows(const P& p, const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           typename P::Acc* __restrict__ y,
                           const int32_t* __restrict__ perm, const Sched& s,
                           int b) {
  const int warp = threadIdx.x >> 5;
  if constexpr (has_row_open<P>::value) {   // open_warp_rows rows a warp
    int bin = 1;
    while (bin < kBins - 1 && b >= s.block_begin[bin + 1]) ++bin;
    const int n_rows = open_warp_rows(s, bin);
    const long long first =
        s.row_begin[bin] +
        ((long long)(b - s.block_begin[bin]) * kWarps + warp) * n_rows;
    open_rows<P>(p, ptr, ind, y, perm, bin, n_rows, first,
                 s.row_begin[bin + 1]);
    return;
  }
  if (b < s.block_begin[2]) {
    const long long k =
        s.row_begin[1] + (long long)(b - s.block_begin[1]) * kWarps + warp;
    if (k < s.row_begin[2]) warp_row<P>(p, ptr, ind, y, __ldg(perm + k));
    return;
  }
  // the short bins: bin 2 + j has groups of 32 >> j lanes
  int bin = 2;
  while (bin < kBins - 1 && b >= s.block_begin[bin + 1]) ++bin;
  const int rows_a_warp = 1 << (bin - 2);
  const long long first =
      s.row_begin[bin] +
      ((long long)(b - s.block_begin[bin]) * kWarps + warp) * rows_a_warp;
  const int end = s.row_begin[bin + 1];
  switch (bin) {
    case 2:
      group_rows<P, 32>(p, ptr, ind, y, perm, first, end);
      break;
    case 3:
      group_rows<P, 16>(p, ptr, ind, y, perm, first, end);
      break;
    case 4:
      group_rows<P, 8>(p, ptr, ind, y, perm, first, end);
      break;
    default:
      group_rows<P, 4>(p, ptr, ind, y, perm, first, end);
  }
}

// bins 1 .. 5: block i is the schedule's block block_begin[1] + i
template <class P>
__global__ void __launch_bounds__(kThreads)
other_rows_kernel(const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ ind,
                  typename P::Acc* __restrict__ y,
                  const int32_t* __restrict__ perm, const Sched s,
                  const P p) {
  other_rows<P>(p, ptr, ind, y, perm, s, s.block_begin[1] + (int)blockIdx.x);
  // after a long rows' grid, its y is written when this grid ends (with no
  // such grid nothing is awaited)
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches the schedule on `stream` and returns the first launch error:
// the long rows' clusters, when the schedule has long rows, then the grid
// of the other bins. The caller never passes a schedule with no block.
template <class P>
cudaError_t launch(const P& p, const int32_t* ptr, const int32_t* ind,
                   typename P::Acc* y, const int32_t* perm,
                   const int32_t* chunk_beg, const Sched& s,
                   cudaStream_t stream) {
  const int long_blocks = s.block_begin[1];
  Sched run = s;
  if constexpr (has_row_open<P>::value) {
    // open_warp_rows rows a warp in bins 1 .. 5, whatever the schedule's
    // rows a block
    for (int b = 1; b < kBins; ++b) {
      const int rows_a_block = kWarps * open_warp_rows(s, b);
      run.block_begin[b + 1] =
          run.block_begin[b] +
          (s.row_begin[b + 1] - s.row_begin[b] + rows_a_block - 1) /
              rows_a_block;
    }
  }
  const int other_blocks = run.block_begin[kBins] - long_blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  if (long_blocks > 0) {   // kCluster blocks a long row
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3((unsigned)long_blocks);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, long_rows_kernel<P>, ptr, ind, y, perm, chunk_beg, p);
    if (err != cudaSuccess || other_blocks == 0) return err;
  }
  if (other_blocks == 0) return cudaSuccess;
  // dependent on the long rows' grid when there is one; on nothing of the
  // stream's earlier work otherwise
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = long_blocks > 0 ? 1 : 0;
  cfg.gridDim = dim3((unsigned)other_blocks);
  return cudaLaunchKernelEx(&cfg, other_rows_kernel<P>, ptr, ind, y, perm,
                            run, p);
}

}  // namespace row_schedule
