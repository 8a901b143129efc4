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
// single warp, a third of the call. The rows are now read through the row
// schedule (row_schedule.cuh): short rows several a warp, medium rows a
// warp each, long rows an 8-block cluster each. Each work item sums its
// edges with fmaf in edge order (a fixed tree across lanes, warps and a
// long row's chunks), so two launches are bitwise equal. Uniform 8-edge
// rows (K3's regime) take 4 rows a warp, each row's 32 B of ind and of
// val one sector. x is read through the read-only path and is not staged
// in shared memory (1 MB at RMAT scale 18, above a block's 227 KB).
//
// What still sets the time (PERF.md): at RMAT scale 18 the medium bin is
// about 90% of the call. Its rows of 4097 .. 8192 edges alone take no more
// than a call's fixed cost, so the bin is held by its throughput over all
// rows, not by a tail of warps on long rows. It moves its edges more
// slowly than the gather K6 makes the same kind of random x reads, so the
// 32-byte L2 sectors those reads move are not its floor either. Beyond L2
// every x read fetches a sector from device memory; the call is level with
// torch.mv (cuSPARSE) in both regimes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

#include "row_schedule.cuh"

namespace {

// the schedule's policy: y[i] = sum of val[e] * x[ind[e]], each edge
// folded in by one fmaf (kUnit: every value 1, x added). The restrict
// pointers, x read before val and the literal identity keep the code the
// kernel had before the walk moved to row_schedule.cuh (40 registers);
// without them nvcc gave 32 and the call lost 2-4% against torch.mv on an
// H100 (PERF.md)
template <bool kUnit>
struct PlusTimes {
  using Acc = float;
  struct Item {
    float v, x;
  };
  const float* __restrict__ val;
  const float* __restrict__ x;

  __device__ __forceinline__ float identity() const { return 0.0f; }
  __device__ __forceinline__ Item fetch(int j, long long e) const {
    Item it;
    it.x = __ldg(x + j);
    it.v = kUnit ? 1.0f : __ldg(val + e);
    return it;
  }
  __device__ __forceinline__ float add(float acc, Item it) const {
    return kUnit ? acc + it.x : fmaf(it.v, it.x, acc);
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return a + b;
  }
};

template <bool kUnit>
cudaError_t launch(const int32_t* ptr, const int32_t* ind, const float* val,
                   const float* x, float* y, const int32_t* perm,
                   const int32_t* chunk_beg, const row_schedule::Sched& s,
                   cudaStream_t stream) {
  return row_schedule::launch(PlusTimes<kUnit>{val, x}, ptr, ind, y,
                              perm, chunk_beg, s, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's error (0 on success): the
// long rows' clusters, when the schedule has long rows, then the grid of
// the other bins. `val` may be null: every edge then has the value 1.
// `meta` is a host array of 2 * 7 ints: the blocks where each bin begins
// (and the total), and the positions in perm where each bin begins (and
// n_out). `chunk_beg` holds 8 edge offsets a long row and may be null when
// there is none. The caller allocates y and never passes a schedule with
// no block.
int gb_value_pull(const void* ptr, const void* ind, const void* val,
                  const void* x, void* y, const void* perm,
                  const void* chunk_beg, const int* meta, void* stream) {
  const row_schedule::Sched s = row_schedule::sched_of(meta);
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
