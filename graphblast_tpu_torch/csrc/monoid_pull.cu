// Monoid pull (K4): y[i] = ident (+) ((+) over the edges e of row i of the
// pull orientation of clamp(val[e] (x) x[ind[e]], -FLT_MAX, FLT_MAX)), where
// (+) is min or max and (x) is plus, multiplies or select-second, all in
// fp32. A row with no edges gives the identity, not 0. SSSP runs MinimumPlus
// over the CSC (vxm) each iteration, CC MinimumSelectSecond over the CSR
// (mxv) on the float image of its grandparent ids.
//
// Replaces graphblast_tpu/ops/pallas/monopull.py:172 _mono_kernel (launched
// by _spmv_monoid, monopull.py:399). That kernel lexsorts the edges into
// 4096-square tiles, sweeps 128-lane windows of x, reduces each row with a
// Hillis-Steele run-scan and selects the run totals into y through a one-hot
// matrix-unit product with presence rows and a hi/lo bf16 split: all of it
// because the TPU has no scatter and its matrix unit wants dense tiles. Here
// the plan is the pull orientation's CSR, one warp per output row, its 32
// lanes stride over the row's edges reading x through the read-only cache,
// each lane folds its products into a register that starts at the identity,
// and a butterfly of warp shuffles folds the 32 registers. min and max do
// not depend on order, so the result equals the plain PyTorch version's
// (gather, product, clamp, scatter_reduce) and two launches agree bitwise.
// Products use __fadd_rn / __fmul_rn, never a fused multiply-add, so they
// round exactly as the plain version's. The clamp turns an overflow such as
// FLT_MAX + w (SSSP's unreached sentinel plus a weight) into FLT_MAX, as the
// TPU kernel's saturation does; with select-second the value array is not
// read at all.
//
// Bound on an H100 SXM: memory. Each call must read ind (4 B per edge), val
// (4 B per edge, none for select-second), ptr (n_out + 1), x (n_in) and
// write y (n_out): at RMAT scale 18, 64,028,004 B for MinimumPlus over the
// CSC (19.1 us at 3.35 TB/s) and 33,586,868 B for MinimumSelectSecond over
// the CSR (10.0 us). Rows shorter than 32 edges leave lanes idle, and the
// hub row (25,077 edges at RMAT scale 18, 784 strided steps) runs long on
// one warp: balancing them is work for a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// (+) and (x) codes; the wrapper passes the same numbers
constexpr int kMin = 0, kMax = 1;
constexpr int kPlus = 0, kMul = 1, kSecond = 2;

template <int kAdd>
__device__ __forceinline__ float fold(float a, float b) {
  return kAdd == kMin ? fminf(a, b) : fmaxf(a, b);
}

template <int kAdd, int kTimes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
monoid_pull_kernel(const int32_t* __restrict__ ptr,
                   const int32_t* __restrict__ ind,
                   const float* __restrict__ val,
                   const float* __restrict__ x,
                   float* __restrict__ y, int n_out, float ident) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_out) return;  // whole warps leave together
  const long long beg = __ldg(ptr + row);
  const long long end = __ldg(ptr + row + 1);
  float acc = ident;
  for (long long e = beg + lane; e < end; e += 32) {
    const float xv = __ldg(x + __ldg(ind + e));
    float p = xv;
    if (kTimes != kSecond) {
      const float a = val == nullptr ? 1.0f : __ldg(val + e);
      p = kTimes == kPlus ? __fadd_rn(a, xv) : __fmul_rn(a, xv);
    }
    acc = fold<kAdd>(acc, fminf(fmaxf(p, -FLT_MAX), FLT_MAX));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = fold<kAdd>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[row] = acc;
}

template <int kAdd, int kTimes>
void launch(const void* ptr, const void* ind, const void* val, const void* x,
            void* y, int n_out, float ident, cudaStream_t stream) {
  const long long blocks =
      ((long long)n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  monoid_pull_kernel<kAdd, kTimes>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
          (const int32_t*)ptr, (const int32_t*)ind, (const float*)val,
          (const float*)x, (float*)y, n_out, ident);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an (add, times) pair with no instantiation.
// add: 0 min, 1 max; times: 0 plus, 1 multiplies, 2 select-second. `val`
// may be null: every edge then has the value 1. The caller allocates y and
// never passes n_out == 0.
int gb_monoid_pull(const void* ptr, const void* ind, const void* val,
                   const void* x, void* y, int n_out, int add, int times,
                   float ident, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (add == kMin && times == kPlus)
    launch<kMin, kPlus>(ptr, ind, val, x, y, n_out, ident, s);
  else if (add == kMin && times == kMul)
    launch<kMin, kMul>(ptr, ind, val, x, y, n_out, ident, s);
  else if (add == kMin && times == kSecond)
    launch<kMin, kSecond>(ptr, ind, val, x, y, n_out, ident, s);
  else if (add == kMax && times == kMul)
    launch<kMax, kMul>(ptr, ind, val, x, y, n_out, ident, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* gb_monoid_pull_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
