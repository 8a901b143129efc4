// Or-pull prefix count (K5): csum[e] = sum over e' <= e of bit(col_ind[e'])
// as int32, where bit(c) = (words[c >> 5] >> (c & 31)) & 1 for a frontier
// packed 32 to a word, and a column c >= 32 * n_words reads 0. The
// structure-only LogicalOrAnd pull without a plan (stepped BFS) turns it into
// the or of each row by fetching csum at row_ptr - 1 (ops/spmv.py).
//
// Replaces graphblast_tpu/ops/pallas/orpull.py:49 _kernel (launched by
// orpull_bit_csum, :108). That kernel walks the edge array in grid order on
// one TPU core, resolves each bit with a lane-gather sweep over the bitmap
// held in VMEM, and chains the prefix sum from one grid step to the next
// through a scalar carry. Blocks on Hopper run in no order, so the carry
// becomes a device-wide scan in three launches over tiles of 4096 edges:
//   1. each block counts the set bits of its tile;
//   2. one block turns the tile counts into exclusive tile offsets;
//   3. each block counts its tile again, scans it in 16 rounds of 256 edges
//      (a warp scan with __shfl_up_sync, then the 8 warp totals through
//      shared memory) and writes the running count plus its tile offset.
// Integer sums, so the result is exact and the same on every launch. The
// bitmap (32 KB at RMAT scale 18) stays in L1/L2; each edge's word is read
// through the read-only cache.
//
// Bound on an H100 SXM: memory. The function must read col_ind (4 B an
// edge) and the bitmap (4 B a word) and write csum (4 B an edge):
// 4 * (2 m + n_words) bytes, 60.9 MB at RMAT scale 18 (m = nnz_pad =
// 7,610,368, 8,192 words), 18.2 us at 3.35 TB/s. Passes 1 and 3 both read
// col_ind, so this simple version moves 4 m bytes more than the bound:
// a single-pass scan with decoupled look-back is work for a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // 8 warps a block
constexpr int kRounds = 16;                 // 16 rounds of 256 edges
constexpr int kTile = kThreads * kRounds;   // 4096 edges a tile
constexpr int kScanThreads = 1024;          // the tile-offset scan's block

__device__ __forceinline__ int frontier_bit(const uint32_t* __restrict__ words,
                                            unsigned long long nbits,
                                            int32_t c) {
  const uint32_t u = (uint32_t)c;  // a negative column is >= nbits too
  return u < nbits ? (int)((__ldg(words + (u >> 5)) >> (u & 31u)) & 1u) : 0;
}

// Inclusive scan of v over the block's kWarps warps; `total` gets the sum
// over the block. `warp_sums` is shared, kWarps entries. Every thread of
// the block must call it.
template <int kWarps>
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();  // warp_sums is free again for the next call
  return v + before;
}

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const uint32_t* __restrict__ words, unsigned long long nbits,
                  const int32_t* __restrict__ col, long long m,
                  int32_t* __restrict__ tile_sums) {
  __shared__ int warp_sums[kThreads / 32];
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long e = base + (long long)r * kThreads;
    if (e < m) cnt += frontier_bit(words, nbits, __ldg(col + e));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    tile_sums[blockIdx.x] = total;
  }
}

// One block: tile_sums[t] becomes the exclusive prefix of the tile counts.
__global__ void __launch_bounds__(kScanThreads)
tile_offsets_kernel(int32_t* __restrict__ tile_sums, long long n_tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  int carry = 0;
  for (long long c = 0; c < n_tiles; c += kScanThreads) {
    const long long t = c + threadIdx.x;
    const int v = t < n_tiles ? tile_sums[t] : 0;
    int total;
    const int incl = block_inclusive_scan<kScanThreads / 32>(v, warp_sums,
                                                             total);
    if (t < n_tiles) tile_sums[t] = carry + incl - v;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const uint32_t* __restrict__ words, unsigned long long nbits,
                 const int32_t* __restrict__ col, long long m,
                 const int32_t* __restrict__ tile_offsets,
                 int32_t* __restrict__ csum) {
  __shared__ int warp_sums[kThreads / 32];
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  int running = tile_offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long e = base + (long long)r * kThreads;
    const int bit = e < m ? frontier_bit(words, nbits, __ldg(col + e)) : 0;
    int total;
    const int incl = block_inclusive_scan<kThreads / 32>(bit, warp_sums,
                                                         total);
    if (e < m) csum[e] = running + incl;
    running += total;
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns the first
// cudaGetLastError() that is not 0, else 0. `tile_sums` is int32 scratch of
// ceil(m / 4096) entries. The caller allocates csum and tile_sums, never
// passes m == 0, and keeps m below 2^31 so that every count fits int32.
int gb_orpull_csum(const void* words, long long n_words, const void* col,
                   void* csum, long long m, void* tile_sums, void* stream) {
  const auto s = (cudaStream_t)stream;
  const unsigned long long nbits = 32ull * (unsigned long long)n_words;
  const long long n_tiles = (m + kTile - 1) / kTile;
  tile_count_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const uint32_t*)words, nbits, (const int32_t*)col, m,
      (int32_t*)tile_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_offsets_kernel<<<1, kScanThreads, 0, s>>>((int32_t*)tile_sums,
                                                 n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const uint32_t*)words, nbits, (const int32_t*)col, m,
      (const int32_t*)tile_sums, (int32_t*)csum);
  return (int)cudaGetLastError();
}

const char* gb_orpull_csum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
