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
// VMEM gate. Here one kernel with no size gate serves both call sites: the
// plan is the pull orientation's CSR, one warp per output row, its 32 lanes
// stride over the row's edges reading x through the read-only cache, and a
// warp-shuffle sum in a fixed order gives y[i]. Every row is written (a row
// with no edges gives 0), and two launches on the same input give bitwise
// equal results.
//
// Bound on an H100 SXM: memory. Each call must read ind and val once (8 B
// per edge), ptr (n_out + 1), x (n_in) and write y (n_out):
// 8*nnz + 4*(n_out + 1) + 4*n_in + 4*n_out bytes, 64.0 MB at RMAT scale 18
// (19.1 us at 3.35 TB/s). At n = 2^24 x is 64 MB and no longer fits the
// 50 MB L2, so random 4-byte reads of x fetch whole 32-byte sectors and
// the time rises well above the byte bound. Rows shorter than 32 edges
// leave lanes idle, and a hub row runs long on one warp (25,077 edges, 784
// strided steps, at RMAT scale 18): balancing them is work for a later
// change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kUnit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
value_pull_kernel(const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ ind,
                  const float* __restrict__ val,
                  const float* __restrict__ x,
                  float* __restrict__ y, int n_out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_out) return;  // whole warps leave together
  const long long beg = __ldg(ptr + row);
  const long long end = __ldg(ptr + row + 1);
  float acc = 0.0f;
  for (long long e = beg + lane; e < end; e += 32) {
    const float xv = __ldg(x + __ldg(ind + e));
    acc = kUnit ? acc + xv : fmaf(__ldg(val + e), xv, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). `val`
// may be null: every edge then has the value 1. The caller allocates y and
// never passes n_out == 0.
int gb_value_pull(const void* ptr, const void* ind, const void* val,
                  const void* x, void* y, int n_out, void* stream) {
  const long long blocks =
      ((long long)n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  const auto* p = (const int32_t*)ptr;
  const auto* i = (const int32_t*)ind;
  const auto* v = (const float*)val;
  const auto* xs = (const float*)x;
  auto* ys = (float*)y;
  if (v == nullptr)
    value_pull_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        p, i, v, xs, ys, n_out);
  else
    value_pull_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        p, i, v, xs, ys, n_out);
  return (int)cudaGetLastError();
}

const char* gb_value_pull_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
