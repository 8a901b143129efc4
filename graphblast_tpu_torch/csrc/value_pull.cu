// Value pull (K2 and K3): y[i] = sum over the edges e of row i of the pull
// orientation of val[e] * x[ind[e]], fp32 products and fp32 accumulation,
// the Plus-Times SpMV that PageRank runs each iteration. With no value
// array (a unit-valued plan) each edge contributes x[ind[e]], so (y > 0) on
// a 0/1 frontier is the LogicalOrAnd pull.
//
// Replaces graphblast_tpu/ops/pallas/bilinear.py:_kernel and _kernel_packed
// (K2, x and y resident in VMEM, run by spmv_bilinear) and
// _kernel_f32_dma (K3, x windows and y panels fetched by DMA above the VMEM
// gate, run by spmv_bilinear_dma). Those tile the edges into 4096-square
// blocks with bit-packed local ids, sweep 128-lane windows of x and scatter
// the products with a one-hot matrix-unit matmul in a hi/lo bf16 split, all
// to fit VMEM and the matrix unit; the two layouts exist only because of the
// VMEM gate. Here one kernel with no size gate serves both call sites over
// the pull orientation's CSR.
//
// Bound on an H100 SXM: memory. Each call must read ind and val once (8 B
// per edge), ptr (n_out + 1), x (n_in) and write y (n_out):
// 8*nnz + 4*(n_out + 1) + 4*n_in + 4*n_out bytes, 64.0 MB at RMAT scale 18
// (19.1 us at 3.35 TB/s). At n = 2^24 x is 64 MB and no longer fits the
// 50 MB L2, so random 4-byte reads of x fetch whole 32-byte sectors and
// the time rises above the byte bound whatever the schedule.
//
// The schedule. One warp a row (the first design) left most lanes idle on
// the short rows that make up most of an RMAT graph or a uniform CSR, and
// ran a hub row (25,077 edges at RMAT scale 18) as 784 strided steps on a
// single warp, a third of the call. Rows are now binned by length L, once
// per sparsity structure (value_pull.py build_schedule, torch ops on the
// plan's device), and the kernel reads rows through `perm`, the rows
// stably sorted by bin:
//   - long rows, L > T: each is one thread-block cluster (Hopper) of 8
//     blocks, and block j of the cluster sums the row's j-th eighth, its
//     chunk (a fixed tree: each thread's strided edges in order, a warp
//     shuffle, the 8 warp sums in order) into its shared memory. After a
//     cluster barrier block 0 reads the 8 chunk sums through distributed
//     shared memory and adds them in chunk order. Blocks run in no order
//     and float atomics would make two launches differ; here every sum
//     has a fixed order, so two launches are bitwise equal. The partial
//     sums never leave the cluster: no scratch in device memory and no
//     state kept between calls, so calls over one schedule may overlap.
//     The clusters are a launch of their own (a cluster shape on the
//     whole grid slowed its other blocks, which need no cluster), and the
//     grid of the other bins follows as a programmatic dependent
//     launch: it starts once every cluster block has started, runs beside
//     them, and each of its blocks waits for the cluster grid only at its
//     end, so that work after the call sees every row. The hub row
//     (25,077 edges at RMAT scale 18) runs on 8 SMs, about 3,100 edges
//     each;
//   - medium rows, 32 < L <= T: one warp strides the row;
//   - short rows, L <= 32: a group of g lanes a row, g the power of two
//     from 4 to 32 that is at least L, so a warp serves 32/g rows with
//     every lane on an edge. Uniform 8-edge rows (K3's regime) take 4 rows
//     a warp, each row's 32 B of ind and of val one sector.
// The second grid's blocks map to work by bin: the medium rows (8 a
// block), then the four short bins (8 * 32/g rows a block). A thread's
// strided loop takes four edges an iteration, four reads of x in flight.
// T = 8192 (value_pull.py LONG_ROW), from a sweep of T and of a fixed
// chunk length over 2048 .. 16384 at RMAT scale 18 on an H100 in an
// earlier design (PERF.md): T = 8192 was 1.35-3.0% faster than 4096, T =
// 16384 18-19% slower; a check of this design put 8192 first again.
// x is read through the read-only path and is not staged in shared memory
// (1 MB at RMAT scale 18, above a block's 227 KB). What still sets the
// time (PERF.md): at RMAT scale 18 the medium bin is about 90% of the
// call. Its rows of 4097 .. 8192 edges alone take no more than a call's
// fixed cost, so the bin is held by its throughput over all rows, not by
// a tail of warps on long rows. It moves its edges more slowly than the
// gather K6 makes the same kind of random x reads, so the 32-byte L2
// sectors those reads move are not its floor either. Beyond
// L2 every x read fetches a sector from device memory; the call is level
// with torch.mv (cuSPARSE) in both regimes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

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

template <bool kUnit>
__device__ __forceinline__ float edge(const int32_t* __restrict__ ind,
                                      const float* __restrict__ val,
                                      const float* __restrict__ x,
                                      long long e, float acc) {
  const float xv = __ldg(x + __ldg(ind + e));
  return kUnit ? acc + xv : fmaf(__ldg(val + e), xv, acc);
}

// acc plus the products of edges e, e + kStep, e + 2 kStep, ... below end,
// added in that order; four edges an iteration, so that four reads of ind
// and then four of x are in flight at once
template <bool kUnit, int kStep>
__device__ __forceinline__ float strided_sum(const int32_t* __restrict__ ind,
                                             const float* __restrict__ val,
                                             const float* __restrict__ x,
                                             long long e, long long end,
                                             float acc) {
  for (; e + 3 * kStep < end; e += 4 * kStep) {
    int j[4];
    float xv[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) j[u] = __ldg(ind + e + u * kStep);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = __ldg(x + j[u]);
      v[u] = kUnit ? 1.0f : __ldg(val + e + u * kStep);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc = kUnit ? acc + xv[u] : fmaf(v[u], xv[u], acc);
  }
  for (; e < end; e += kStep) acc = edge<kUnit>(ind, val, x, e, acc);
  return acc;
}

// the sum over lanes [0, width) of each group of `width` lanes, in lane 0
template <int kWidth>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, kWidth);
  return acc;
}

// block b of the long bin: chunk b % kCluster of long row b / kCluster,
// edges chunk_beg[b] .. the next chunk's start (the row's end for the
// last); the cluster's block 0 writes the row's y
template <bool kUnit>
__device__ void long_chunk(const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           const float* __restrict__ val,
                           const float* __restrict__ x, float* __restrict__ y,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ chunk_beg, int b) {
  __shared__ float warp_sums[kWarps];
  __shared__ float chunk_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = b % kCluster;
  const int row = __ldg(perm + b / kCluster);
  const long long beg = __ldg(chunk_beg + b);
  const long long end = j + 1 < kCluster ? __ldg(chunk_beg + b + 1)
                                         : __ldg(ptr + row + 1);
  float acc = strided_sum<kUnit, kThreads>(ind, val, x, beg + threadIdx.x,
                                          end, 0.0f);
  acc = group_sum<32>(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    chunk_sum = total;
  }
  cluster.sync();   // every chunk's sum is in its block's shared memory
  if (j == 0 && threadIdx.x == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      sum += *cluster.map_shared_rank(&chunk_sum, r);
    y[row] = sum;
  }
  cluster.sync();   // no block leaves while block 0 reads its shared memory
}

template <bool kUnit>
__device__ void warp_row(const int32_t* __restrict__ ptr,
                         const int32_t* __restrict__ ind,
                         const float* __restrict__ val,
                         const float* __restrict__ x, float* __restrict__ y,
                         int row) {
  const int lane = threadIdx.x & 31;
  const long long beg = __ldg(ptr + row);
  const long long end = __ldg(ptr + row + 1);
  float acc = strided_sum<kUnit, 32>(ind, val, x, beg + lane, end, 0.0f);
  acc = group_sum<32>(acc);
  if (lane == 0) y[row] = acc;
}

// 32/G rows a warp, G lanes a row of at most G edges
template <bool kUnit, int G>
__device__ void group_rows(const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           const float* __restrict__ val,
                           const float* __restrict__ x, float* __restrict__ y,
                           const int32_t* __restrict__ perm, long long first,
                           int row_end) {
  const int lane = threadIdx.x & 31;
  if (first >= row_end) return;   // whole warps leave together
  const long long k = first + lane / G;
  int row = -1;
  float acc = 0.0f;
  if (k < row_end) {
    row = __ldg(perm + k);
    const long long e = __ldg(ptr + row) + lane % G;
    if (e < __ldg(ptr + row + 1)) acc = edge<kUnit>(ind, val, x, e, 0.0f);
  }
  acc = group_sum<G>(acc);
  if (lane % G == 0 && row >= 0) y[row] = acc;
}

// the long rows: a cluster of kCluster blocks a row
template <bool kUnit>
__global__ void __launch_bounds__(kThreads)
long_rows_kernel(const int32_t* __restrict__ ptr,
                 const int32_t* __restrict__ ind,
                 const float* __restrict__ val,
                 const float* __restrict__ x, float* __restrict__ y,
                 const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ chunk_beg) {
  // the grid of the other bins may start beside this one
  asm volatile("griddepcontrol.launch_dependents;");
  long_chunk<kUnit>(ptr, ind, val, x, y, perm, chunk_beg, (int)blockIdx.x);
}

// block b of bins 1 .. 5, numbered as in the schedule
template <bool kUnit>
__device__ void other_rows(const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ ind,
                           const float* __restrict__ val,
                           const float* __restrict__ x, float* __restrict__ y,
                           const int32_t* __restrict__ perm, const Sched& s,
                           int b) {
  const int warp = threadIdx.x >> 5;
  if (b < s.block_begin[2]) {
    const long long k =
        s.row_begin[1] + (long long)(b - s.block_begin[1]) * kWarps + warp;
    if (k < s.row_begin[2])
      warp_row<kUnit>(ptr, ind, val, x, y, __ldg(perm + k));
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
      group_rows<kUnit, 32>(ptr, ind, val, x, y, perm, first, end);
      break;
    case 3:
      group_rows<kUnit, 16>(ptr, ind, val, x, y, perm, first, end);
      break;
    case 4:
      group_rows<kUnit, 8>(ptr, ind, val, x, y, perm, first, end);
      break;
    default:
      group_rows<kUnit, 4>(ptr, ind, val, x, y, perm, first, end);
  }
}

// bins 1 .. 5: block i is the schedule's block block_begin[1] + i
template <bool kUnit>
__global__ void __launch_bounds__(kThreads)
value_pull_kernel(const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ ind,
                  const float* __restrict__ val,
                  const float* __restrict__ x, float* __restrict__ y,
                  const int32_t* __restrict__ perm, const Sched s) {
  other_rows<kUnit>(ptr, ind, val, x, y, perm, s,
                    s.block_begin[1] + (int)blockIdx.x);
  // after a long rows' grid, its y is written when this grid ends (with no
  // such grid nothing is awaited)
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool kUnit>
cudaError_t launch(const int32_t* ptr, const int32_t* ind, const float* val,
                   const float* x, float* y, const int32_t* perm,
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
        &cfg, long_rows_kernel<kUnit>, ptr, ind, val, x, y, perm, chunk_beg);
    if (err != cudaSuccess || other_blocks == 0) return err;
  }
  if (other_blocks == 0) return cudaSuccess;
  // dependent on the long rows' grid when there is one; on nothing of the
  // stream's earlier work otherwise
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = long_blocks > 0 ? 1 : 0;
  cfg.gridDim = dim3((unsigned)other_blocks);
  return cudaLaunchKernelEx(&cfg, value_pull_kernel<kUnit>, ptr, ind, val, x,
                            y, perm, s);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success): the
// long rows' clusters, when the schedule has long rows, then the grid of
// the other bins. `val` may be null: every edge then has the value 1.
// `meta` is a host array of 2 * 7 ints: the blocks where each bin begins
// (and the total), and the positions in perm where each bin begins (and
// n_out). `chunk_beg` holds kCluster edge offsets a long row and may be
// null when there is none. The caller allocates y and never passes a
// schedule with no block.
int gb_value_pull(const void* ptr, const void* ind, const void* val,
                  const void* x, void* y, const void* perm,
                  const void* chunk_beg, const int* meta, void* stream) {
  Sched s;
  for (int b = 0; b <= kBins; ++b) {
    s.block_begin[b] = meta[b];
    s.row_begin[b] = meta[kBins + 1 + b];
  }
  const auto* p = (const int32_t*)ptr;
  const auto* i = (const int32_t*)ind;
  const auto* v = (const float*)val;
  const auto* xs = (const float*)x;
  auto* ys = (float*)y;
  const auto* pm = (const int32_t*)perm;
  const auto* cb = (const int32_t*)chunk_beg;
  const auto st = (cudaStream_t)stream;
  const cudaError_t err =
      v == nullptr ? launch<true>(p, i, v, xs, ys, pm, cb, s, st)
                   : launch<false>(p, i, v, xs, ys, pm, cb, s, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* gb_value_pull_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
