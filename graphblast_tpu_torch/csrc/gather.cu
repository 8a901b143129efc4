// Gather (K6): y[i] = x[clamp(idx[i], 0, n - 1)] for a 1-D table of 4-byte
// entries (float32 or int32, moved as raw 32-bit words) and int32 indices.
// Every pull without a plan runs it through `take`: the gather of x at the
// column ids (MIS, graph colouring, CC at n >= 2^24) and the fetch of
// segment tails and of prefix sums at the row boundaries.
//
// Replaces graphblast_tpu/ops/pallas/gather.py:45 _gather_kernel (launched
// by gather_1d, :99) and :113 _gather_small_kernel (gather_1d_small, :145).
// Both exist because the TPU has only a 128-entry lane gather: they sweep
// the table's 128-wide rows and select, with a per-chunk [min, max] row
// range to prune the sweep when the indices are sorted, and a full sweep
// for tables of at most 128 rows. None of that is needed here: a thread
// reads its index and then its table entry through the read-only cache.
// One kernel serves both TPU entries, whatever the size or the order of the
// indices (two CUDA kernels below: the four-query one and a scalar one
// for misaligned pointers). The index is clamped into the table, as the
// JAX package's off-TPU `x[idx]` does, so no read leaves the table.
//
// Bound on an H100 SXM: memory. Each call must read idx (4 B a query) and
// write y (4 B a query), and can touch at most min(n, m) table entries:
// 4 * (2 m + min(n, m)) bytes. For MIS's gather of x at the CSC row ids at
// RMAT scale 18 (m = 7,610,368, n = 262,144) that is 61.9 MB, 18.5 us at
// 3.35 TB/s; the 1 MB table stays in the 50 MB L2, so the random table
// reads cost L2 latency, not device-memory bytes, though each 4-byte read
// moves a 32-byte L2 sector (about 244 MB through L2 for that gather).
//
// The design against it. A thread takes four consecutive queries: one
// 16-byte load of idx, four independent clamped table reads in flight, one
// 16-byte store of y, so each warp keeps 128 table reads in flight against
// the L2 latency and the idx and y streams move in full 512-byte warp
// transactions. The queries past the last multiple of four, and any call
// whose idx or y is not 16-byte aligned (a contiguous slice such as
// idx[1:]), take the scalar path, one query a thread. At the row
// boundaries (m = n + 1 = 262,145) the card works about 2 us a call and
// the time is the host's launch path (ops/kernels/_build.py launcher).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the scalar kernel's grid-stride loop runs on at most this many blocks:
// 32 resident blocks of 256 threads on each of the 132 SMs
constexpr long long kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint32_t entry(const uint32_t* __restrict__ x,
                                          long long j, long long n) {
  return __ldg(x + (j < 0 ? 0 : (j >= n ? n - 1 : j)));
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ y, long long m, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride)
    y[i] = entry(x, __ldg(idx + i), n);
}

// idx and y 16-byte aligned: a quad of queries a thread, and the m % 4
// left over on the first threads
__global__ void __launch_bounds__(kThreads)
gather4_kernel(const uint32_t* __restrict__ x, const int4* __restrict__ idx,
               uint4* __restrict__ y, long long m, long long n) {
  const long long quads = m >> 2;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < quads) {
    const int4 j = __ldg(idx + t);
    uint4 v;
    v.x = entry(x, j.x, n);
    v.y = entry(x, j.y, n);
    v.z = entry(x, j.z, n);
    v.w = entry(x, j.w, n);
    y[t] = v;
  }
  if (t < (m & 3)) {
    const long long i = 4 * quads + t;
    ((uint32_t*)y)[i] = entry(x, __ldg((const int32_t*)idx + i), n);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates y and never passes m == 0 or n == 0.
int gb_gather(const void* x, const void* idx, void* y, long long m,
              long long n, void* stream) {
  const bool aligned = (((uintptr_t)idx | (uintptr_t)y) & 15) == 0;
  // the four-query kernel takes one quad a thread; the scalar one loops
  long long blocks = ((aligned ? (m + 3) >> 2 : m) + kThreads - 1) / kThreads;
  if (!aligned && blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (aligned)
    gather4_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int4*)idx, (uint4*)y, m, n);
  else
    gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int32_t*)idx, (uint32_t*)y, m, n);
  return (int)cudaGetLastError();
}

const char* gb_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
