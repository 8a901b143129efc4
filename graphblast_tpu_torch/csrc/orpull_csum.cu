// Or-pull prefix count (K5): csum[e] = sum over e' <= e of bit(col_ind[e'])
// as int32, where bit(c) = (words[c >> 5] >> (c & 31)) & 1 for a frontier
// packed 32 to a word, and a column c >= 32 * n_words, or a negative one,
// reads 0. The structure-only LogicalOrAnd pull without a plan (stepped
// BFS) turns it into the or of each row by fetching csum at row_ptr - 1
// (ops/spmv.py).
//
// Replaces graphblast_tpu/ops/pallas/orpull.py:49 _kernel (launched by
// orpull_bit_csum, :108). That kernel walks the edge array in grid order on
// one TPU core, resolves each bit with a lane-gather sweep over the bitmap
// held in VMEM, and chains the prefix sum from one grid step to the next
// through a scalar carry. Blocks on Hopper run in no order, so the carry
// becomes a single-pass scan with decoupled look-back, in one launch over
// tiles of 8,192 edges, 16 edges to each of a block's 512 threads:
//   1. each block takes the next tile id from a counter in device memory
//      (an atomic in launch order, not blockIdx), so every tile it may wait
//      on belongs to a block that is already running;
//   2. it reads its tile's columns once (16-byte loads where col_ind and
//      csum are 16-byte aligned and the tile is whole), counts the bits and
//      publishes the tile's count, the aggregate;
//   3. its first warp looks back over the predecessors' published words,
//      32 tiles at a time, summing aggregates until it meets an inclusive
//      prefix, then publishes its own inclusive prefix;
//   4. every thread writes its edges' running counts (16-byte stores).
// A thread holds four groups of four consecutive edges, group g at
// 4 (g * 512 + t) in the tile, so that each load and store instruction
// of a warp covers 512 contiguous bytes. The block scans the four groups'
// counts at once as four 16-bit fields of one 64-bit word (a field sums at
// most 4 * 512 = 2048 bits, so no field carries into the next). At RMAT
// scale 18 on an NVIDIA H100 80GB HBM3 at 700 W, tiles of 2,048 edges took
// 20-30% longer than 4,096, and 8,192 were 0.1-2% faster than 4,096
// (PERF.md, the K5 tile sweep).
//
// A tile's status and value are one 64-bit word (flag in the high half:
// 0 nothing yet, 1 aggregate, 2 inclusive prefix; the count in the low
// half), written with one st.release.gpu and read with ld.acquire.gpu, so
// no reader sees a flag without its value. The counter and the status
// words are scratch of the call, zeroed on the call's stream by the C entry
// before the launch: nothing is kept between calls, and calls on two
// streams never share scratch. Integer sums, so the result is exact and
// the same on every launch.
//
// Bound on an H100 SXM: memory. The function must read col_ind (4 B an
// edge) and the bitmap (4 B a word) and write csum (4 B an edge):
// 4 * (2 m + n_words) bytes, 60.9 MB over the CSC at RMAT scale 18 (m =
// nnz_pad = 7,610,368, 8,192 words), 18.2 us at 3.35 TB/s. The kernel
// reads col_ind once; the three-launch version it replaces read it twice.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroups = 4;   // groups of four edges a thread
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = kThreads * 4 * kGroups;   // 8,192 edges
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ uint32_t frontier_bit(
    const uint32_t* __restrict__ words, unsigned long long nbits, int32_t c) {
  const uint32_t u = (uint32_t)c;  // a negative column is >= nbits too
  return u < nbits ? (__ldg(words + (u >> 5)) >> (u & 31u)) & 1u : 0u;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// field g of a word of four 16-bit counts
__device__ __forceinline__ int field(unsigned long long w, int g) {
  return (int)((w >> (16 * g)) & 0xffffu);
}

// `scratch` is the call's zeroed scratch: the tile counter, then one status
// word a tile. `vec`: col and csum are 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
orpull_csum_kernel(const uint32_t* __restrict__ words,
                   unsigned long long nbits, const int32_t* __restrict__ col,
                   long long m, int32_t* __restrict__ csum,
                   unsigned long long* scratch, bool vec) {
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ int tile_s, prefix_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = (int)atomicAdd((unsigned int*)scratch, 1u);
  __syncthreads();
  const int tile = tile_s;
  unsigned long long* status = scratch + 1;
  const long long base = (long long)tile * kTile;
  const bool whole = vec && base + kTile <= m;

  // bit 4 g + i: edge base + 4 (g kThreads + t) + i
  uint32_t bits = 0;
  if (whole) {
    int4 c[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      c[g] = __ldg((const int4*)(col + base) + g * kThreads + t);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      bits |= (frontier_bit(words, nbits, c[g].x) |
               frontier_bit(words, nbits, c[g].y) << 1 |
               frontier_bit(words, nbits, c[g].z) << 2 |
               frontier_bit(words, nbits, c[g].w) << 3)
              << (4 * g);
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long e = base + 4 * (g * kThreads + t) + i;
        if (e < m) bits |= frontier_bit(words, nbits, __ldg(col + e))
                           << (4 * g + i);
      }
  }

  // the block's exclusive scan of the four groups' counts, in fields
  unsigned long long packed = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    packed |= (unsigned long long)__popc((bits >> (4 * g)) & 15u) << (16 * g);
  unsigned long long incl = packed;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long s = warp_sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  const unsigned long long excl = incl - packed + before;
  int agg = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) agg += field(total, g);

  if (tile == 0) {
    if (t == 0) {
      publish(status, kPrefix | (uint32_t)agg);
      prefix_s = 0;
    }
  } else {
    if (t == 0) publish(status + tile, kAggregate | (uint32_t)agg);
    if (warp == 0) {
      // lane l reads tile pred - l; a tile before 0 reads as a prefix of 0
      int prefix = 0;
      int pred = tile - 1;
      for (;;) {
        const int j = pred - lane;
        const unsigned long long s = j >= 0 ? observe(status + j) : kPrefix;
        const uint32_t flag = (uint32_t)(s >> 32);
        if (__any_sync(0xffffffffu, flag == 0)) continue;   // not yet
        const uint32_t found = __ballot_sync(0xffffffffu, flag == 2);
        const int stop = found ? __ffs(found) - 1 : 31;
        int v = lane <= stop ? (int)(uint32_t)s : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        prefix += v;
        if (found) break;
        pred -= 32;
      }
      if (lane == 0) {
        publish(status + tile, kPrefix | (uint32_t)(prefix + agg));
        prefix_s = prefix;
      }
    }
  }
  __syncthreads();

  int running = prefix_s;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int pre = running + field(excl, g);
    running += field(total, g);
    const uint32_t b = (bits >> (4 * g)) & 15u;
    const int4 out = make_int4(pre + (int)(b & 1u), pre + __popc(b & 3u),
                               pre + __popc(b & 7u), pre + __popc(b));
    const long long e = base + 4 * (g * kThreads + t);
    if (whole) {
      ((int4*)(csum + base))[g * kThreads + t] = out;
    } else {
      if (e < m) csum[e] = out.x;
      if (e + 1 < m) csum[e + 1] = out.y;
      if (e + 2 < m) csum[e + 2] = out.z;
      if (e + 3 < m) csum[e + 3] = out.w;
    }
  }
}

}  // namespace

extern "C" {

// Zeroes the scratch and launches the scan on `stream`; returns the first
// error, else 0. `scratch` holds ceil(m / 8192) + 1 64-bit words. The
// caller allocates csum and scratch, never passes m == 0, and keeps m
// below 2^31 so that every count fits int32.
int gb_orpull_csum(const void* words, long long n_words, const void* col,
                   void* csum, long long m, void* scratch, void* stream) {
  const auto st = (cudaStream_t)stream;
  const long long n_tiles = (m + kTile - 1) / kTile;
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(n_tiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (((uintptr_t)col | (uintptr_t)csum) & 15) == 0;
  orpull_csum_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const uint32_t*)words, 32ull * (unsigned long long)n_words,
      (const int32_t*)col, m, (int32_t*)csum, (unsigned long long*)scratch,
      vec);
  return (int)cudaGetLastError();
}

const char* gb_orpull_csum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
