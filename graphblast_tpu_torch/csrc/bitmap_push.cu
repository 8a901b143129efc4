// Bitmap push (P): the structure-only push under a duplicate-insensitive
// semiring add (LogicalOr, Max), which BFS runs. The new frontier is the set
// of the frontier's out-neighbours that pass the mask; a destination only
// has to be marked once, so the kernel marks a bitmap instead of sorting the
// expanded edges (GraphBLAST's struconly push, spmspv_inner.hpp:133-134,
// 228-251, 292-299), and compacts the bitmap into the frontier's two images.
//
// Replaces no TPU kernel: the JAX package lowers this push to jnp (a
// workspace of a fixed tier of lanes, a sort by destination and a
// compaction of the segment heads, graphblast_tpu/ops/spmspv.py), and so did
// the port (ops/spmspv.py, every gather on K6). Added because that lowering
// ranks, gathers and sorts every lane of the tier: on GAP kron at scale 25
// its pushes took 0.5-1 G lanes and 132 ms of each BFS call on an NVIDIA
// H100 80GB HBM3 at 700 W, where this kernel takes 2.4 ms.
//
// Stages, five launches from one C entry on one stream:
//   1. pack: the mask's pass bits, one 32-bit word a thread, a warp reading
//      32 consecutive floats a step and packing them by ballot. `pass`
//      holds the passing vertices (the vertices below n where there is no
//      mask); `seen` starts as its complement, so that a vertex that fails
//      the mask reads as already marked;
//   2. expand: ceil(deg_total / 4,096) blocks of 4,096 edges, the edges
//      numbered in frontier order. A block finds its first frontier slot by
//      one warp's 32-ary search of the degrees' inclusive scan `incl`
//      (merge path), then each slot in its range writes its id at its first
//      edge's position in shared memory and a max-scan gives every edge its
//      slot. Threads read consecutive edges, so the column ids are read
//      coalesced, and a hub's row spreads over many blocks (one block reads
//      one row with no scan). Each edge reads its destination's word of
//      `seen` through L2 and sets the bit with atomicOr where it is unset;
//   3. count: the new vertices (seen & pass) a tile of 2,048 words;
//   4. scan: the tiles' exclusive prefix in one block, and nv, the total;
//   5. write: each tile writes y (1.0 at a new vertex, else 0), its new ids
//      at their ranks in sind, and its share of sind's pads (the value n),
//      ranked after every new id: a tile's pads follow the pads of the tiles
//      before it.
// Integer work only, and the result is a set: it is the same on every
// launch whatever order the blocks and atomics run in.
//
// Bound on an H100 SXM: memory. A push must read each expanded edge's
// column id (4 B), the mask (4 B a vertex) and write y and sind (4 B a
// vertex each): 4 (deg_total + 3 n) bytes. The random words of `seen` are
// n / 8 bytes, 4 MB at n = 2^25, which stay in the 50 MB L2.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (graphblast_tpu_torch/ops/kernels/_build.py)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                            // edges a thread
constexpr long long kEdges = kThreads * kPer;      // 4,096 edges a block
constexpr int kWordsPer = 4;                       // words a thread
constexpr long long kTileWords = kThreads * kWordsPer;   // 2,048 words
constexpr int kPackThreads = 256;
constexpr int kScanThreads = 1024;

// stage 1: pass[w] = the pass bits of vertices 32 w .. 32 w + 31 (0 past n),
// seen[w] = ~pass[w]. Warp k packs words 32 k .. 32 k + 31.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ mask, bool scmp, long long n,
            long long nwords, uint32_t* __restrict__ pass,
            uint32_t* __restrict__ seen) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      (((long long)blockIdx.x * kPackThreads + threadIdx.x) >> 5) * 32;
  if (w0 >= nwords) return;   // the whole warp
  uint32_t mine = 0;
  for (int j = 0; j < 32 && w0 + j < nwords; ++j) {
    const long long v = (w0 + j) * 32 + lane;
    bool ok = v < n;
    if (ok && mask != nullptr) {
      const bool nz = __ldg(mask + v) != 0.0f;   // NaN passes, -0.0 not
      ok = scmp ? !nz : nz;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == j) mine = bits;
  }
  if (w0 + lane < nwords) {
    pass[w0 + lane] = mine;
    seen[w0 + lane] = ~mine;
  }
}

// the first s in [0, snv) with incl[s] > x, or snv; all 32 lanes of a warp
// call it and get the answer
__device__ int first_above(const int32_t* __restrict__ incl, int snv,
                           long long x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = snv;   // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const long long p = lo + (long long)lane * step;
    const bool above = p >= hi || __ldg(incl + p) > x;
    const uint32_t m = __ballot_sync(0xffffffffu, above);
    if (m == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      if (f == 0) return lo;
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
    }
  }
  const int p = lo + lane;
  const bool above = p >= hi || __ldg(incl + p) > x;
  const uint32_t m = __ballot_sync(0xffffffffu, above);
  return m ? lo + __ffs(m) - 1 : hi;
}

// mark the destinations c[0..kPer) (a value of -1, or any id not below n,
// marks nothing): every word is read before the first atomic
__device__ __forceinline__ void mark(uint32_t* seen, const int32_t* c,
                                     uint32_t n) {
  uint32_t word[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t u = (uint32_t)c[k];
    word[k] = u < n ? __ldcg(seen + (u >> 5)) : 0xffffffffu;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t u = (uint32_t)c[k];
    const uint32_t bit = 1u << (u & 31u);
    if (!(word[k] & bit)) atomicOr(seen + (u >> 5), bit);
  }
}

// stage 2: block b takes edges [4096 b, 4096 (b + 1)) of the frontier's
// deg_total edges, edge e of slot s being column id ind[e + delta[s]]
// (delta[s] = the row's start minus the slot's first edge)
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ incl,
              const int32_t* __restrict__ delta, int snv,
              const int32_t* __restrict__ ind, uint32_t n,
              uint32_t* seen) {
  __shared__ __align__(16) int owner[kEdges];
  __shared__ int warp_max[kWarps];
  __shared__ int lo_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long total = __ldg(incl + snv - 1);
  const long long base = (long long)blockIdx.x * kEdges;
  if (base >= total) return;   // the whole block
  const long long end = min(base + kEdges, total);
  if (warp == 0) {
    const int lo = first_above(incl, snv, base);
    if (lane == 0) lo_s = lo;
  }
  __syncthreads();
  const int lo = lo_s;
  int32_t c[kPer];
  if (__ldg(incl + lo) >= end) {   // one row holds every edge of the block
    const long long d = __ldg(delta + lo);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + t;
      c[k] = e < end ? __ldg(ind + e + d) : -1;
    }
    mark(seen, c, n);
    return;
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) owner[k * kThreads + t] = -1;
  __syncthreads();
  // each nonempty slot writes its id at its first edge in the block; the
  // slots past the block's last edge stop the loop
  for (int s0 = lo;; s0 += kThreads) {
    const int s = s0 + t;
    bool more = false;
    if (s < snv) {
      const long long ex = s > 0 ? __ldg(incl + s - 1) : 0;
      if (ex < end) {
        more = true;
        if (__ldg(incl + s) > ex)
          owner[(int)((ex > base ? ex : base) - base)] = s;
      }
    }
    if (!__syncthreads_or(more)) break;
  }
  // inclusive max-scan of owner, thread t holding entries 8 t .. 8 t + 7;
  // entry 0 is slot lo's, so every entry ends up a slot
  int v[kPer];
  const int4 a = reinterpret_cast<const int4*>(owner)[2 * t];
  const int4 b = reinterpret_cast<const int4*>(owner)[2 * t + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#pragma unroll
  for (int k = 1; k < kPer; ++k) v[k] = max(v[k], v[k - 1]);
  int run = v[kPer - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run = max(run, u);
  }
  if (lane == 31) warp_max[warp] = run;
  int before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = max(v[k], before);
  reinterpret_cast<int4*>(owner)[2 * t] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(owner)[2 * t + 1] =
      make_int4(v[4], v[5], v[6], v[7]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pos = k * kThreads + t;
    const long long e = base + pos;
    c[k] = e < end ? __ldg(ind + e + __ldg(delta + owner[pos])) : -1;
  }
  mark(seen, c, n);
}

// block-wide exclusive sum of x over kThreads threads; *total gets the sum
__device__ __forceinline__ int block_exclusive_sum(int x, int* warp_sum,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  *total = all;
  return before + incl - x;
}

// stage 3: counts[tile] = the new vertices of the tile's 2,048 words
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint32_t* __restrict__ seen,
             const uint32_t* __restrict__ pass, long long nwords,
             int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  const long long w0 = (long long)blockIdx.x * kTileWords;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kWordsPer; ++k) {
    const long long w = w0 + k * kThreads + threadIdx.x;
    if (w < nwords) c += __popc(seen[w] & pass[w]);
  }
  int total;
  block_exclusive_sum(c, warp_sum, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// stage 4: counts becomes its exclusive prefix; *nv the total
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int ntiles, int32_t* __restrict__ nv) {
  __shared__ int warp_sum[kScanThreads / 32];
  int carry = 0;
  for (int b = 0; b < ntiles; b += kScanThreads) {
    const int i = b + threadIdx.x;
    const int x = i < ntiles ? counts[i] : 0;
    int total;
    const int ex = block_exclusive_sum(x, warp_sum, &total);
    if (i < ntiles) counts[i] = carry + ex;
    carry += total;
    __syncthreads();   // warp_sum is read before the next chunk writes it
  }
  if (threadIdx.x == 0) *nv = carry;
}

// stage 5: tile k's vertices are [65536 k, min(65536 (k + 1), n))
__global__ void __launch_bounds__(kThreads)
write_kernel(const uint32_t* __restrict__ seen,
             const uint32_t* __restrict__ pass, long long nwords,
             long long n, const int* __restrict__ prefix,
             const int32_t* __restrict__ nv, float* __restrict__ y,
             int32_t* __restrict__ sind) {
  __shared__ __align__(16) uint32_t words[kTileWords];
  __shared__ int warp_sum[kWarps];
  const int t = threadIdx.x;
  const long long w0 = (long long)blockIdx.x * kTileWords;
  const long long v0 = 32 * w0;
  // thread t holds words 4 t .. 4 t + 3 of the tile, so that its new ids
  // follow the ids of every thread before it
  uint32_t mw[kWordsPer];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kWordsPer; ++j) {
    const long long w = w0 + kWordsPer * t + j;
    mw[j] = w < nwords ? seen[w] & pass[w] : 0u;
    words[kWordsPer * t + j] = mw[j];
    cnt += __popc(mw[j]);
  }
  int tile_new;
  int pos = prefix[blockIdx.x] +
            block_exclusive_sum(cnt, warp_sum, &tile_new);   // syncs words
#pragma unroll
  for (int j = 0; j < kWordsPer; ++j) {
    const int id0 = (int)(v0 + 32 * (kWordsPer * t + j));
    for (uint32_t bits = mw[j]; bits; bits &= bits - 1)
      sind[pos++] = id0 + __ffs(bits) - 1;
  }
  const long long nv_ = *nv;
  const long long vn = min(32 * kTileWords, n - v0);   // the tile's vertices
  for (long long i = 4 * t; i < vn; i += 4 * kThreads) {
    const uint32_t wd = words[i >> 5] >> (i & 31);
    if (i + 4 <= vn) {
      *reinterpret_cast<float4*>(y + v0 + i) =
          make_float4((float)(wd & 1u), (float)((wd >> 1) & 1u),
                      (float)((wd >> 2) & 1u), (float)((wd >> 3) & 1u));
    } else {
      for (long long r = 0; i + r < vn; ++r)
        y[v0 + i + r] = (float)((wd >> r) & 1u);
    }
  }
  // the pads: this tile's vertices that are not new, after the nv new ids
  // and after the pads of the tiles before it
  const long long pad0 = nv_ + (v0 - prefix[blockIdx.x]);
  for (long long i = t; i < vn - tile_new; i += kThreads)
    sind[pad0 + i] = (int32_t)n;
}

}  // namespace

extern "C" {

// The push on `stream`; returns the first error, else 0. `scratch` holds
// 2 ceil(n / 32) + ceil(n / 65536) 32-bit words; y (float32) and sind
// (int32) have n entries and nv one int32. `mask` is float32 over n
// vertices, or null. incl and delta have snv entries (unread where snv or
// deg_total is 0). The caller keeps 0 < n < 2^31 and deg_total < 2^31.
int gb_bitmap_push(const void* mask, int scmp, long long n,
                   const void* incl, const void* delta, long long snv,
                   long long deg_total, const void* ind, void* scratch,
                   void* y, void* sind, void* nv, void* stream) {
  const auto st = (cudaStream_t)stream;
  const long long nwords = (n + 31) / 32;
  const long long ntiles = (nwords + kTileWords - 1) / kTileWords;
  uint32_t* pass = (uint32_t*)scratch;
  uint32_t* seen = pass + nwords;
  int* counts = (int*)(seen + nwords);
  cudaError_t err;
  // a warp packs 32 words
  const long long pack_threads = 32 * ((nwords + 31) / 32);
  pack_kernel<<<(unsigned)((pack_threads + kPackThreads - 1) / kPackThreads),
                kPackThreads, 0, st>>>((const float*)mask, scmp != 0, n,
                                       nwords, pass, seen);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (snv > 0 && deg_total > 0) {
    expand_kernel<<<(unsigned)((deg_total + kEdges - 1) / kEdges), kThreads,
                    0, st>>>((const int32_t*)incl, (const int32_t*)delta,
                             (int)snv, (const int32_t*)ind, (uint32_t)n,
                             seen);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  count_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(seen, pass, nwords,
                                                      counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, (int)ntiles, (int32_t*)nv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  write_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      seen, pass, nwords, n, counts, (const int32_t*)nv, (float*)y,
      (int32_t*)sind);
  return (int)cudaGetLastError();
}

const char* gb_bitmap_push_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
