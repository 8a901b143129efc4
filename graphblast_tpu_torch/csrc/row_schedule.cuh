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
// all __device__ and const where they are members. A policy without
// empty_row() compiles to the walk it had before the hook: the test sits
// behind `if constexpr`. `launch<P>` runs the two grids on a stream.
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
  const long long beg = __ldg(chunk_beg + b);
  const long long end = j + 1 < kCluster ? __ldg(chunk_beg + b + 1)
                                         : __ldg(ptr + row + 1);
  Acc acc = strided_fold<P, kThreads>(p, ind, beg + threadIdx.x, end,
                                      p.identity());
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
  const int other_blocks = s.block_begin[kBins] - long_blocks;
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
  return cudaLaunchKernelEx(&cfg, other_rows_kernel<P>, ptr, ind, y, perm, s,
                            p);
}

}  // namespace row_schedule
